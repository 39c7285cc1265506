"""`wavelet_roofline_pct.encode`: the wavelet layer's least time (colour,
the bank's levels and the deadzone quantizer on every pixel, u8 pixels
and the real symbols once each; core.work_dwt.wavelet_s) over the device
time of the items launched under the route's `wavelet` span, per call,
in %; nothing where the run counted no wavelet work."""

from portbench.core import work_dwt
from portbench.layer_metrics import _slice


def read(rec: dict):
    if "wavelet_taps" not in rec["work"]:
        return None
    return _slice.share_pct(work_dwt.wavelet_s(rec["work"]),
                            _slice.per_call_s(rec, "enc", "wavelet"))
