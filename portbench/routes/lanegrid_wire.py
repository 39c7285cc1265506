"""Route `lanegrid_wire`: the lane-grid still clip, wire-complete.

Encode: B3 grid -> `grid_lanes_lmajor` -> K1 + K2's row mode
(`rans_encode_rows`) -> `assemble_stream`, which joins the rows' prefixes
into the wire words (one host read of the counts).  The answer is the
compact stream in device memory: words, n_words, final states and
per-step counts.  Decode: K3's look-back decode of the words
(`rans_decode_grouped` with the counts) -> `grid_unlanes_lmajor` -> B4
grid.  The rows are cut to a column cap of twice the largest per-step
word count over the pool, in 128s (bench.py's rule).
"""

from __future__ import annotations

import torch

from portbench.core import discover
from portbench.reference import rans as rrans
from portbench.routes import _lanegrid
from portbench.routes._lanegrid import rd, re_

REACHES = ("B3 grid", "K1", "K2 rows", "K3", "B4 grid")
BYPASSES = ("grid decode",)


class Route:
    def __init__(self, config: dict, workload: dict, clips: list, span):
        lg = self.lg = _lanegrid.LaneGrid(config, clips, span)
        self.span = span
        self.pixel_bytes = lg.pixel_bytes
        cmax = max(int(re_.rans_encode_rows(
            lg.lanes(lg.planes(c)).t(), lg.fg, lg.cg)[1].max()) for c in clips)
        self.cap = min(max(-(-cmax * 2 // 128) * 128, 128), lg.s)

    def encode(self, clip: torch.Tensor):
        lg = self.lg
        with self.span("transform"):
            planes = lg.planes(clip)
        with self.span("entropy"):
            rows, counts, states = re_.rans_encode_rows(
                lg.lanes(planes).t(), lg.fg, lg.cg)
            words, n_words = re_.assemble_stream(rows[:, :self.cap], counts)
        return words, n_words, states, counts

    def decode(self, stream):
        lg = self.lg
        words, n_words, states, counts = stream
        with self.span("entropy"):
            lanes = rd.rans_decode_grouped(
                words[:int(n_words)], states, lg.fg, lg.cg, lg.l, counts).t()
        with self.span("transform"):
            return lg.frames(lanes)

    def counters(self) -> dict:
        return _lanegrid.counters()

    def work(self, streams: list) -> dict:
        n_words = sum(int(s[1]) for s in streams) / len(streams)
        return self.lg.work(n_words, wire=True)

    def static(self) -> dict:
        return self.lg.static()


def setup(config, workload, clips, span) -> Route:
    discover.require(config, _lanegrid.IMPLEMENTS)
    return Route(config, workload, clips, span)


def symbols_of(stream, static: dict):
    words, n_words, states, counts = stream
    w = words[:int(n_words)].view(torch.int16).to(torch.int64) & 0xFFFF
    return rrans.decode(w, states, static["freqs"], static["l"],
                        counts=counts)


def check(ctx) -> dict:
    return _lanegrid.check(ctx, lambda s: symbols_of(s, ctx.static))


control = _lanegrid.control
