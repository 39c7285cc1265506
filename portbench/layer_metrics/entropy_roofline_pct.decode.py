"""`entropy_roofline_pct.decode`: the entropy layer's least time (bytes
only: symbols, words, states, counts where the stream has them, tables;
core.work.entropy_s) over the device time of the items launched under
the route's `entropy` span, per call, in %."""

from portbench.core import work
from portbench.layer_metrics import _slice


def read(rec: dict):
    return _slice.share_pct(work.entropy_s(rec["work"]),
                            _slice.per_call_s(rec, "dec", "entropy"))
