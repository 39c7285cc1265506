"""Route `dwt_wire`: VCF's 2D-DWT intra composition on every frame of a
clip, wire-complete, on vcf_tpu_torch's DWT clip path.

Encode: `DWT.clip_to_lanes` (colour, the bank's levels, the deadzone
quantizer and the byte planes, then the clip's (G * sg * N, L) lane
grid) -> K1's context mode and K2 (`entropy.rans.encode_lanes_device`).
The answer is the compact stream in device memory: words, n_words, final
states and per-step counts.  Decode: K3's context look-back decode of
the words (`rans_decode_ctx` with the counts) -> `DWT.lanes_to_clip`.
The (G, n_ctx, 256) tables are trained once in set-up on the pool's
first clip's lanes and then frozen: static side information, as the III
cells' `grans` tables.
"""

from __future__ import annotations

import torch
from vcf_tpu_torch import Codec, CodecConfig
from vcf_tpu_torch.entropy import dwt_device as dd
from vcf_tpu_torch.entropy import rans
from vcf_tpu_torch.ops.cuda import dct_kernel as dk
from vcf_tpu_torch.ops.cuda import rans_ctx
from vcf_tpu_torch.ops.cuda import rans_decode as rd
from vcf_tpu_torch.ops.cuda import rans_encode as re_

from portbench.core import discover
from portbench.reference import compare, dwt as rdwt, rans_ctx as rctx

#: what the route and the reference implement: a configuration that
#: states anything else is refused at set-up
IMPLEMENTS = {"spatial": "dwt", "wavelet": "db5", "levels": 5,
              "color": "ycocg", "quantizer": "deadzone", "entropy": "cgrans",
              "context_classes": 4, "groups": 17, "prob_bits": 15,
              "state_bits": 32, "word_bits": 16,
              "precision": "float32 colour, bank and quantizer as fused "
                           "multiply-add chains, TF32 off"}
REACHES = ("K1 ctx", "K2", "K3 ctx")
BYPASSES = ("K1", "K2 rows", "K3", "grid decode", "ctx grid decode",
            "B3 grid", "B4 grid")


class Route:
    def __init__(self, config: dict, workload: dict, clips: list, span):
        self.span = span
        self.qss, self.levels = config["qss"], config["levels"]
        self.n_ctx = config["context_classes"]
        self.device = clips[0].device
        self.codec = Codec(CodecConfig(
            spatial="dwt", wavelet=config["wavelet"], dwt_levels=self.levels,
            color=config["color"], quantizer=config["quantizer"],
            qss=self.qss, entropy=config["entropy"],
            context_classes=self.n_ctx), device=self.device)
        self.dwt = self.codec._dwt
        n, h, w, c = clips[0].shape
        self.frames, self.shape = n, (h, w, c)
        self.pixel_bytes = n * h * w * c
        self.sizes = self.dwt._grid_sizes(self.shape)
        self.g = len(self.sizes)
        self.sg, self.l = dd.grid_dims(self.sizes)
        self.symbols = n * sum(self.sizes)
        self.set_tables(*dd.train_ctx_tables(self.lanes(clips[0]), self.g,
                                             self.n_ctx))

    def lanes(self, clip: torch.Tensor) -> torch.Tensor:
        return self.dwt.clip_to_lanes(self.codec, clip)

    def frames_of(self, lanes: torch.Tensor) -> torch.Tensor:
        return self.dwt.lanes_to_clip(self.codec, lanes, self.shape)

    def set_tables(self, freqs, cums) -> None:
        """The static (G, n_ctx, 256) tables the coder uses from now on."""
        self.freqs = freqs
        self.fg = torch.from_numpy(freqs.astype("int64")).to(self.device)
        self.cg = torch.from_numpy(cums.astype("int64")).to(self.device)

    def encode(self, clip: torch.Tensor):
        with self.span("wavelet"):
            lanes = self.lanes(clip)
        with self.span("entropy"):
            words, n_words, counts, states = rans.encode_lanes_device(
                lanes, self.fg, self.cg)
        return words, n_words, states, counts

    def decode(self, stream):
        words, n_words, states, counts = stream
        with self.span("entropy"):
            lanes = rans_ctx.rans_decode_ctx(
                words[:int(n_words)], states, self.fg, self.cg, self.l,
                counts)
        with self.span("wavelet"):
            return self.frames_of(lanes)

    def counters(self) -> dict:
        return {"K1 ctx": rans_ctx.rans_encode_ctx.launches,
                "K2": re_.rans_compact.launches,
                "K3 ctx": rans_ctx.rans_decode_ctx.launches,
                "K1": re_.rans_encode_grouped.launches,
                "K2 rows": re_.rans_compact_rows.launches,
                "K3": rd.rans_decode_grouped.launches,
                "grid decode": rd.rans_decode_grouped_grid.launches,
                "ctx grid decode": rans_ctx.rans_decode_ctx_grid.launches,
                "B3 grid": dk.fused_cdct_quantize.grid_launches,
                "B4 grid": dk.fused_dequantize_cdct.grid_launches}

    def work(self, streams: list) -> dict:
        h, w, c = self.shape
        hp, wp, _, _ = rdwt.padding(h, w, self.levels)
        return {"pixel_bytes": self.pixel_bytes, "symbols": self.symbols,
                "elements": self.frames * hp * wp * c,
                "wavelet_taps": len(rdwt.DB5), "levels": self.levels,
                "s_streams": self.g * self.sg * self.frames,
                "l_steps": self.l, "groups": self.g, "n_ctx": self.n_ctx,
                "n_words": sum(int(s[1]) for s in streams) / len(streams)}

    def static(self) -> dict:
        return {"freqs": self.freqs, "shape": self.shape,
                "frames": self.frames, "l": self.l, "g": self.g,
                "n_ctx": self.n_ctx, "qss": self.qss, "levels": self.levels}


def setup(config, workload, clips, span) -> Route:
    discover.require(config, IMPLEMENTS)
    return Route(config, workload, clips, span)


def check(ctx) -> dict:
    """The numbers of a clip's answers (see reference.compare): the
    indexes a stream decodes to (by the reference's context decoder)
    against the reference's float64 indexes of the clip, and a decode's
    pixels against the reference's decode of the same stream."""
    st = ctx.static
    shape, n, qss, levels = st["shape"], st["frames"], st["qss"], st["levels"]
    ref = {}

    def ref_lanes(p):
        if p not in ref:
            ref[p] = rdwt.forward_grid(ctx.clips[p], qss, levels)
        return ref[p]

    out = compare.Readings()
    out.add("table_diff_entries", compare.table_diff(
        st["freqs"], rctx.tables(ref_lanes(0), st["g"], st["n_ctx"])))
    out.add("stream_errors", 0)
    decoded = {}

    def lanes_of(stream):
        if id(stream) not in decoded:
            words, n_words, states, counts = stream
            w = words[:int(n_words)].view(torch.int16).to(torch.int64) & 0xFFFF
            lanes, errors = rctx.decode(w, states, st["freqs"], st["l"],
                                        counts)
            out.add("stream_errors", errors)
            decoded[id(stream)] = lanes
        return decoded[id(stream)]

    for p, stream in ctx.enc_samples:
        share, over1 = rdwt.index_diffs(lanes_of(stream), ref_lanes(p),
                                        shape, n, levels)
        out.worst("enc_index_diff_share", share)
        out.worst("enc_index_diff_over1", over1)
    for p, frames in ctx.dec_samples:
        want = rdwt.inverse_grid(lanes_of(ctx.streams[p]), shape, n, qss,
                                 levels)
        out.worst("dec_pixel_diff_share", compare.diff_share(frames, want))
        out.worst("dec_pixel_diff_over1", compare.diff_over1(frames, want))
    return out.values


def control(route, clips: list) -> None:
    """The control in the program's place, after set-up: the reference
    computed with TF32 products for the wavelet layer both ways, and its
    tables trained on its own lanes of the first clip.  The program's
    entropy coder stays."""
    route.lanes = lambda clip: rdwt.forward_grid(clip, route.qss,
                                                 route.levels, tf32=True)
    route.frames_of = lambda lanes: rdwt.inverse_grid(
        lanes, route.shape, route.frames, route.qss, route.levels, tf32=True)
    freqs = rctx.tables(route.lanes(clips[0]), route.g, route.n_ctx)
    route.set_tables(freqs, rctx.cums_of(freqs))
