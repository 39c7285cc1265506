"""Route `ipp_grid`: IPPCodec's planar subband-grid closed loop with the
entropy coder left on the device (the composition of
benchmarks/bench_ipp.py, on vcf_tpu_torch).

Encode: the clip as a batch of GOPs through `_gop_encode_grid_batch`
(per P step: the luma FMA chain, SAD full search, MC, B3/B4 grid and the
elementwise residual and reconstruction) -> `grid_lanes_lmajor` -> K1.
The answer is K1's raw grid, the final states and the mvs, in device
memory.  Decode: the grid decode -> `grid_unlanes_lmajor` ->
`_gop_decode_grid_batch`.  The `grans` tables are trained once in set-up
on the first clip's index planes and then frozen.
"""

from __future__ import annotations

import torch
from vcf_tpu_torch import CodecConfig, VideoConfig, video
from vcf_tpu_torch.entropy import rans
from vcf_tpu_torch.ops.cuda import dct_kernel as dk
from vcf_tpu_torch.ops.cuda import mc_kernel as mc
from vcf_tpu_torch.ops.cuda import rans_decode as rd
from vcf_tpu_torch.ops.cuda import rans_encode as re_
from vcf_tpu_torch.ops.cuda import sad_kernel as sad

from portbench.core import discover
from portbench.reference import compare, ipp as ripp, lanes as rlanes
from portbench.reference import rans as rrans

#: what the route and the reference implement: a configuration that
#: states anything else is refused at set-up
IMPLEMENTS = {"spatial": "dct", "color": "ycocg", "quantizer": "deadzone",
              "subbands": False, "fast_search": False, "rdo_lambda": 0.0,
              "luma": "BT.601 (0.299, 0.587, 0.114) as a float32 fused "
                      "multiply-add chain",
              "entropy": "grans", "prob_bits": 15, "state_bits": 32,
              "word_bits": 16, "groups": 64, "block_size": 8,
              "precision": "float32 transform and quantizer, TF32 off; "
                           "SADs exact (float64 sums)"}
REACHES = ("SAD", "MC", "B3 grid", "B4 grid", "K1", "grid decode")
BYPASSES = ("K2 rows", "K3")


class Route:
    def __init__(self, config: dict, workload: dict, clips: list, span):
        self.span = span
        self.b, self.qss, self.g = (config["block_size"], config["qss"],
                                    config["groups"])
        self.gop, self.m, self.srange = (config["gop_size"],
                                         config["me_block"],
                                         config["search_range"])
        n, h, w, _ = clips[0].shape
        self.hw = (h, w)
        self.shape = (n, 3, h, w)
        self.symbols = n * 3 * h * w
        self.pixel_bytes = n * h * w * 3
        vcfg = VideoConfig(mode="ipp", n_frames=n, gop_size=self.gop,
                           me_block=self.m, search_range=self.srange)
        ccfg = CodecConfig(entropy="grans", subbands=False,
                           block_size=self.b, qss=self.qss)
        self.ipp = video.get(vcfg, ccfg, clips[0].device)
        self.s = rans.RANSCodec._pick_streams(self.symbols,
                                              config["n_streams"])
        self.cw = dk._chunk_w(w, self.b)
        self.l = self.symbols // self.s
        self.loop_encode = self.ipp._gop_encode_grid_batch
        self.loop_decode = self.ipp._gop_decode_grid_batch
        self.device = clips[0].device
        planes0, _ = self.loop_encode(self.gops(clips[0]))
        self.set_tables(*rans.freqs_from_counts(rans.group_histograms(
            self.lanes(planes0).t(), self.g).cpu().numpy()))

    def set_tables(self, freqs, cums) -> None:
        """The static (G, 256) tables the coder uses from now on."""
        self.freqs = freqs
        self.fg = torch.from_numpy(freqs.astype("int64")).to(self.device)
        self.cg = torch.from_numpy(cums.astype("int64")).to(self.device)

    def gops(self, clip):
        h, w = self.hw
        return clip.reshape(-1, self.gop, h, w, 3)

    def lanes(self, planes):
        return rans.grid_lanes_lmajor(planes.reshape(self.shape), self.b,
                                      self.s, cw=self.cw)

    def unlanes(self, lanes_lm):
        h, w = self.hw
        return rans.grid_unlanes_lmajor(lanes_lm, self.b, self.shape,
                                        cw=self.cw
                                        ).reshape(-1, self.gop, 3, h, w)

    def encode(self, clip: torch.Tensor):
        with self.span("gop_loop"):
            planes, mvs = self.loop_encode(self.gops(clip))
        with self.span("entropy"):
            raw, states = re_.rans_encode_grouped(
                self.lanes(planes).t(), self.fg, self.cg)
        return raw, states, mvs

    def decode(self, stream):
        raw, states, mvs = stream
        with self.span("entropy"):
            planes = self.unlanes(rd.rans_decode_grouped_grid(
                raw, states, self.fg, self.cg, self.l).t())
        with self.span("gop_loop"):
            return self.loop_decode(planes, mvs)

    def counters(self) -> dict:
        return {"SAD": sad.sad_search.launches,
                "MC": mc.mc_apply_planar.launches,
                "B3 grid": dk.fused_cdct_quantize.grid_launches,
                "B4 grid": dk.fused_dequantize_cdct.grid_launches,
                "K1": re_.rans_encode_grouped.launches,
                "K2 rows": re_.rans_compact_rows.launches,
                "K3": rd.rans_decode_grouped.launches,
                "grid decode": rd.rans_decode_grouped_grid.launches}

    def work(self, streams: list) -> dict:
        n_words = sum(int(((raw >> 16) != 0).sum()) for raw, _, _ in streams
                      ) / len(streams)
        n, _, h, w = self.shape
        return {"pixel_bytes": self.pixel_bytes, "symbols": self.symbols,
                "s_streams": self.s, "l_steps": self.l, "groups": self.g,
                "n_words": n_words, "wire": False,
                "p_frames": n - n // self.gop, "pixels": h * w,
                "blocks": (h // self.m) * (w // self.m), "block": self.m,
                "search": self.srange}

    def static(self) -> dict:
        return {"freqs": self.freqs, "shape": self.shape, "s": self.s,
                "l": self.l, "g": self.g, "qss": self.qss, "b": self.b,
                "gop": self.gop, "m": self.m, "search": self.srange}

    def close(self) -> None:
        self.ipp.last_grid_recon = None


def setup(config, workload, clips, span) -> Route:
    discover.require(config, IMPLEMENTS)
    return Route(config, workload, clips, span)


def _ref_gops(clip, st):
    n, _, h, w = st["shape"]
    return clip.reshape(-1, st["gop"], h, w, 3)


def check(ctx) -> dict:
    """The numbers of an IPP clip's answers (see reference.compare): the
    reference closed loop on each clip compared, the stream decoded by
    the reference decoder, its decode by the reference decoder loop."""
    st = ctx.static
    n, _, h, w = st["shape"]
    gt = (n // st["gop"], st["gop"], 3, h, w)
    ref = {}

    def ref_loop(p):
        if p not in ref:
            ref[p] = ripp.encode(_ref_gops(ctx.clips[p], st), st["m"],
                                 st["search"], st["qss"])
        return ref[p]

    out = compare.Readings()
    out.add("table_diff_entries", compare.table_diff(
        st["freqs"], rrans.tables(rlanes.lanes_of(
            ref_loop(0)[0].reshape(st["shape"]), st["s"], st["b"]),
            st["g"])))
    out.add("stream_errors", 0)
    decoded = {}

    def planes_of(stream):
        if id(stream) not in decoded:
            raw, states, _ = stream
            words, flags = rrans.compact_raw(raw)
            lanes, errors = rrans.decode(words, states, st["freqs"], st["l"],
                                         flags=flags)
            out.add("stream_errors", errors)
            decoded[id(stream)] = rlanes.planes_of(lanes, st["shape"],
                                                   st["b"]).reshape(gt)
        return decoded[id(stream)]

    for p, stream in ctx.enc_samples:
        want_planes, want_mvs = ref_loop(p)
        out.worst("enc_index_diff_share",
                  compare.diff_share(planes_of(stream), want_planes))
        mvs = stream[2]
        out.worst("mv_diff_share", 1.0 if mvs.shape != want_mvs.shape else
                  float((mvs != want_mvs).any(-1).sum()) / mvs[..., 0].numel())
    for p, recon in ctx.dec_samples:
        stream = ctx.streams[p]
        want = ripp.decode(planes_of(stream), stream[2], st["m"], st["qss"])
        out.worst("dec_pixel_diff_share", compare.diff_share(recon, want))
    return out.values


def control(route: Route, clips: list) -> None:
    """The control in the program's place, after set-up: the reference
    closed loop in TF32 for `_gop_encode_grid_batch` and
    `_gop_decode_grid_batch`, its lane law, and its tables trained on its
    own indexes of the first clip.  The program's entropy coder stays."""
    r = route
    r.loop_encode = lambda gops: ripp.encode(gops, r.m, r.srange, r.qss,
                                             tf32=True)
    r.loop_decode = lambda planes, mvs: ripp.decode(planes, mvs, r.m, r.qss,
                                                    tf32=True)
    r.lanes = lambda planes: rlanes.lanes_of(planes.reshape(r.shape), r.s,
                                             r.b)
    r.unlanes = lambda lanes_lm: rlanes.planes_of(
        lanes_lm, r.shape, r.b).reshape(-1, r.gop, *r.shape[1:])
    freqs = rrans.tables(r.lanes(r.loop_encode(r.gops(clips[0]))[0]), r.g)
    r.set_tables(freqs, rrans.cums_of(freqs))
