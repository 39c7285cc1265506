"""`gop_loop_ms.decode`: device ms per clip of the items launched under
the route's `gop_loop` span (IPP's closed loop over the GOP batch)."""

from portbench.layer_metrics import _slice


def read(rec: dict):
    s = _slice.per_call_s(rec, "dec", "gop_loop")
    return None if s is None else s * 1e3
