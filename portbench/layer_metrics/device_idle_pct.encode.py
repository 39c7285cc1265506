"""`device_idle_pct.encode`: the share of the encode half's profiled slice
(first call's start to last call's end) in which no kernel, copy or
memset ran on the card, in %."""

from portbench.layer_metrics import _slice


def read(rec: dict):
    return _slice.idle_pct(rec, "enc")
