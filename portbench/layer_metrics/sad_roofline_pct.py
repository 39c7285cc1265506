"""`sad_roofline_pct`: the full search's least time (3 operations a
term over every block, displacement and pixel of the P frames;
core.work.sad_s) over the device time of the SAD kernels (named
`sad_search...`) launched under the `gop_loop` span of the encode
half, per call, in %."""

from portbench.core import work
from portbench.layer_metrics import _slice


def read(rec: dict):
    return _slice.share_pct(work.sad_s(rec["work"]),
                            _slice.per_call_s(rec, "enc", "gop_loop",
                                              kernel="sad_search"))
