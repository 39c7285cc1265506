"""Route `lanegrid_device`: the lane-grid still clip, device-resident.

Encode: B3 grid -> `grid_lanes_lmajor` -> K1 (`rans_encode_grouped`).
The answer is K1's raw grid ((emit << 16) | low16 per decode step and
lane) and the final states, left in device memory as bench.py's
`device_resident` row leaves them: no row mode, no `assemble_stream`.
Decode: the routing-free grid decode (`rans_decode_grouped_grid`) ->
`grid_unlanes_lmajor` -> B4 grid; no K3.
"""

from __future__ import annotations

import torch

from portbench.core import discover
from portbench.reference import rans as rrans
from portbench.routes import _lanegrid
from portbench.routes._lanegrid import rd, re_

REACHES = ("B3 grid", "K1", "grid decode", "B4 grid")
BYPASSES = ("K2 rows", "K3")


class Route:
    def __init__(self, config: dict, workload: dict, clips: list, span):
        lg = self.lg = _lanegrid.LaneGrid(config, clips, span)
        self.span = span
        self.pixel_bytes = lg.pixel_bytes

    def encode(self, clip: torch.Tensor):
        lg = self.lg
        with self.span("transform"):
            planes = lg.planes(clip)
        with self.span("entropy"):
            return re_.rans_encode_grouped(lg.lanes(planes).t(),
                                                 lg.fg, lg.cg)

    def decode(self, stream):
        lg = self.lg
        raw, states = stream
        with self.span("entropy"):
            lanes = rd.rans_decode_grouped_grid(
                raw, states, lg.fg, lg.cg, lg.l).t()
        with self.span("transform"):
            return lg.frames(lanes)

    def counters(self) -> dict:
        return _lanegrid.counters()

    def work(self, streams: list) -> dict:
        n_words = sum(int(((raw >> 16) != 0).sum()) for raw, _ in streams
                      ) / len(streams)
        return self.lg.work(n_words, wire=False)

    def static(self) -> dict:
        return self.lg.static()


def setup(config, workload, clips, span) -> Route:
    discover.require(config, _lanegrid.IMPLEMENTS)
    return Route(config, workload, clips, span)


def symbols_of(stream, static: dict):
    raw, states = stream
    words, flags = rrans.compact_raw(raw)
    return rrans.decode(words, states, static["freqs"], static["l"],
                        flags=flags)


def check(ctx) -> dict:
    return _lanegrid.check(ctx, lambda s: symbols_of(s, ctx.static))


control = _lanegrid.control
