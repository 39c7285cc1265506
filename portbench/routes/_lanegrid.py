"""What the two lane-grid still-clip routes share (the composition of
bench.py's `run_grid`, on vcf_tpu_torch): set-up, the transform calls,
the work counts and the comparison with the plain reference.

Per clip (N, H, W, 3) uint8 on the device: B3 in the grid layout
(`fused_cdct_quantize`, colour + DCT + quantizer) -> `grid_lanes_lmajor`
-> the entropy coder; back: the entropy decoder -> `grid_unlanes_lmajor`
-> B4 in the grid layout (`fused_dequantize_cdct`).  The `grans` tables
are trained once in set-up on the first clip's lanes and then frozen:
static side information, as bench.py has it.
"""

from __future__ import annotations

import torch
from vcf_tpu_torch.entropy import rans
from vcf_tpu_torch.ops import color
from vcf_tpu_torch.ops.cuda import dct_kernel as dk
from vcf_tpu_torch.ops.cuda import rans_decode as rd
from vcf_tpu_torch.ops.cuda import rans_encode as re_

from portbench.reference import compare, lanes as rlanes, rans as rrans
from portbench.reference import transform as rtransform


#: what the lane-grid routes and the reference implement: a configuration
#: that states anything else is refused at set-up
IMPLEMENTS = {"spatial": "dct", "color": "ycocg", "quantizer": "deadzone",
              "entropy": "grans", "prob_bits": 15, "state_bits": 32,
              "word_bits": 16, "groups": 64, "block_size": 8,
              "precision": "float32 transform and quantizer, TF32 off"}


class LaneGrid:
    """Set-up state and the transform halves of a lane-grid route."""

    def __init__(self, config: dict, clips: list, span):
        self.span = span
        self.b, self.qss, self.g = (config["block_size"], config["qss"],
                                    config["groups"])
        n, h, w, _ = clips[0].shape
        self.shape = (n, 3, h, w)
        self.symbols = n * 3 * h * w
        self.pixel_bytes = n * h * w * 3
        self.s = rans.RANSCodec._pick_streams(self.symbols,
                                              config["n_streams"])
        self.cw = dk._chunk_w(w, self.b)
        self.l = self.symbols // self.s
        self.mf = dk.static_mat(color.YCOCG_FWD)
        self.mi = dk.static_mat(color.YCOCG_INV)
        self.device = clips[0].device
        lanes0 = self.lanes(self.planes(clips[0]))
        self.set_tables(*rans.freqs_from_counts(
            rans.group_histograms(lanes0.t(), self.g).cpu().numpy()))

    def set_tables(self, freqs, cums) -> None:
        """The static (G, 256) tables the coder uses from now on."""
        self.freqs = freqs
        self.fg = torch.from_numpy(freqs.astype("int64")).to(self.device)
        self.cg = torch.from_numpy(cums.astype("int64")).to(self.device)

    def planes(self, clip):
        return dk.fused_cdct_quantize(
            clip.permute(0, 3, 1, 2), self.mf, b=self.b, qss=self.qss,
            grid_layout=True)

    def lanes(self, planes):
        return rans.grid_lanes_lmajor(planes, self.b, self.s, cw=self.cw)

    def frames(self, lanes_lm):
        planes = rans.grid_unlanes_lmajor(lanes_lm, self.b, self.shape,
                                          cw=self.cw)
        return dk.fused_dequantize_cdct(
            planes, self.mi, b=self.b, qss=self.qss, grid_layout=True
        ).permute(0, 2, 3, 1)

    def work(self, n_words: float, wire: bool) -> dict:
        return {"pixel_bytes": self.pixel_bytes, "symbols": self.symbols,
                "s_streams": self.s, "l_steps": self.l, "groups": self.g,
                "block_size": self.b, "n_words": n_words, "wire": wire}

    def static(self) -> dict:
        return {"freqs": self.freqs, "shape": self.shape, "s": self.s,
                "l": self.l, "g": self.g, "qss": self.qss, "b": self.b}


def counters() -> dict:
    """The launch counts of every kernel wrapper the lane-grid routes can
    reach."""
    return {"B3 grid": dk.fused_cdct_quantize.grid_launches,
            "B4 grid": dk.fused_dequantize_cdct.grid_launches,
            "K1": re_.rans_encode_grouped.launches,
            "K2 rows": re_.rans_compact_rows.launches,
            "K3": rd.rans_decode_grouped.launches,
            "grid decode": rd.rans_decode_grouped_grid.launches}


def check(ctx, symbols_of) -> dict:
    """The numbers of a still clip's answers (see reference.compare).
    symbols_of(stream) -> ((L, S) uint8 lanes, stream errors) by the
    reference decoder."""
    st = ctx.static
    shape, s, qss, b = st["shape"], st["s"], st["qss"], st["b"]
    ref = {}

    def ref_planes(p):
        if p not in ref:
            ref[p] = rtransform.forward(ctx.clips[p].permute(0, 3, 1, 2),
                                        qss, b)
        return ref[p]

    out = compare.Readings()
    out.add("table_diff_entries", compare.table_diff(
        st["freqs"], rrans.tables(rlanes.lanes_of(ref_planes(0), s, b),
                                  st["g"])))
    out.add("stream_errors", 0)
    decoded = {}

    def planes_of(stream):
        if id(stream) not in decoded:
            lanes, errors = symbols_of(stream)
            out.add("stream_errors", errors)
            decoded[id(stream)] = rlanes.planes_of(lanes, shape, b)
        return decoded[id(stream)]

    for p, stream in ctx.enc_samples:
        planes = planes_of(stream)
        out.worst("enc_index_diff_share",
                  compare.diff_share(planes, ref_planes(p)))
        out.worst("enc_index_diff_over1",
                  compare.diff_over1(planes, ref_planes(p)))
    for p, frames in ctx.dec_samples:
        want = rtransform.inverse(planes_of(ctx.streams[p]), qss, b
                                  ).permute(0, 2, 3, 1)
        out.worst("dec_pixel_diff_share", compare.diff_share(frames, want))
        out.worst("dec_pixel_diff_over1", compare.diff_over1(frames, want))
    return out.values


def control(route, clips: list) -> None:
    """The control in the program's place, after set-up: the reference's
    TF32 transform for B3 and B4, its lane law, and its tables trained
    on its own indexes of the first clip.  The program's entropy coder
    stays."""
    lg = route.lg
    lg.planes = lambda clip: rtransform.forward(
        clip.permute(0, 3, 1, 2), lg.qss, lg.b, tf32=True)
    lg.lanes = lambda planes: rlanes.lanes_of(planes, lg.s, lg.b)
    lg.frames = lambda lanes_lm: rtransform.inverse(
        rlanes.planes_of(lanes_lm, lg.shape, lg.b), lg.qss, lg.b, tf32=True
    ).permute(0, 2, 3, 1)
    freqs = rrans.tables(lg.lanes(lg.planes(clips[0])), lg.g)
    lg.set_tables(freqs, rrans.cums_of(freqs))
