"""`ctx_entropy_roofline_pct.decode`: the context coder's least time
(bytes only: the real symbols, words, states, per-step counts and the
(G, n_ctx, 256) tables; core.work_dwt.ctx_entropy_s) over the device
time of the items launched under the route's `entropy` span, per call,
in %; nothing where the run counted no context coding."""

from portbench.core import work_dwt
from portbench.layer_metrics import _slice


def read(rec: dict):
    if "n_ctx" not in rec["work"]:
        return None
    return _slice.share_pct(work_dwt.ctx_entropy_s(rec["work"]),
                            _slice.per_call_s(rec, "dec", "entropy"))
