"""`transform_roofline_pct.decode`: the transform layer's least time
(colour + 8x8 DCT + quantizer on every symbol, uint8 in and out;
core.work.transform_s) over the device time of the items launched under
the route's `transform` span, per call, in %."""

from portbench.core import work
from portbench.layer_metrics import _slice


def read(rec: dict):
    w = rec["work"]
    return _slice.share_pct(work.transform_s(w["symbols"], w["block_size"]),
                            _slice.per_call_s(rec, "dec", "transform"))
