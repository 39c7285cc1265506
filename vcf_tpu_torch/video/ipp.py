"""IPP hybrid video codec (port of vcf_tpu/video/ipp.py, the fused GOP loop).

GOPs of `gop_size` frames: the first intra-coded, the rest predicted from
the reconstructed previous frame (closed loop) by block motion search on
luma and motion compensation, the residual shifted by +128 and clipped to
u8 (src/IPP_DCT.py).  Optional per-block intra/inter RDO on luma with
lambda `rdo_lambda`.  The codestream is vcf_tpu's: `clip.*` (one call of
a batched entropy codec over every index plane) or `f%04d*` segments,
`mv_%04d` / `modes_%04d` arrays and the same payload JSON.

vcf_tpu vmaps the GOP loop over GOPs and scans the P chain; here the GOPs
are the batch dimension of every tensor and the P chain is a Python loop
over t.  Pixels stay channel-planar, (G, 3, H, W) float32, through the
loop; index planes are stored channel-last (N, H, W, 3) in vcf_tpu's
layout.  The op order is vcf_tpu's, step for step:

    ref_l = to_luma(clip(round(ref)).u8);  cur_l = to_luma(frame)
    mv = search(ref_l, cur_l);  pred = compensate(ref, mv)
    residual = clip(cur - pred + 128);  k = enc(residual)
    recon = clip(pred + dec(k) - 128)

Routes (`_make_search`, `_compensate`, `_enc`, `_dec`), chosen as
vcf_tpu's: `use_pallas` takes the kernels, `sad_search` (full search),
`mc_apply_planar` and B1/B2 (`fused_dct_quantize` / `fused_dequantize_idct`)
— the kernels on CUDA, their plain versions on the CPU; `use_pallas=False`
the torch route (`motion.full_search`, `motion.compensate`, `analyze` ->
`deadzone_quantize` -> clip).  `fast_search` takes the three-step search.
The color transforms run as `ops.color.fma_rows`, the bits of vcf_tpu's
color dots on any device.

For color "ycocg" the codec also has vcf_tpu's planar subband-grid
closed loop (`_build_planar_gop`, vcf_tpu ipp.py:377-457):
`_gop_encode_grid_batch(gops)` -> (index planes (G, T, 3, H, W) u8 in
the subband-grid tile layout, mvs) and `_gop_decode_grid_batch(planes,
mvs)` -> the reconstruction (G, T, 3, H, W) float32, over the grid
modes of B3/B4 (`fused_cdct_quantize` / `fused_dequantize_cdct`).  The
planes feed `entropy.rans.grid_lanes_lmajor` with plain reshapes.  For
every other color both are None, as in vcf_tpu.  Its luma is vcf_tpu's
planar one: the FMA chain on round(ref), with no clip and no u8 cast, and
on the u8 clip's frame for cur; on CUDA both are one kernel each
(`ops.cuda.luma_kernel`, the round folded in, either layout read where it
lies), elsewhere `to_luma`.
The two run in `vcf.ipp.encode` / `vcf.ipp.decode` spans
(`utils.profiling`), their op groups in `vcf.ipp.luma`, `vcf.ipp.pixels`
(casts, residual, reconstruction) and `vcf.ipp.layout` (the output
stacks, whose bytes count in `layout_bytes`).

Every other composition (not dct + deadzone) takes vcf_tpu's generic
closed loop through the still `Codec` (vcf_tpu ipp.py:601-667; the
reference's encode_decode_proxy, IPP_DCT.py:595-626, without its temp
files): frame by frame, an I frame coded by the still codec, a P frame's
residual clip(cur - pred + 128) truncated to u8 and coded by it, the
reconstruction its decode added back to the prediction.  The frames go
to the still codec as numpy arrays, as in vcf_tpu; the P frames' search
and prediction are `_make_search` and `_compensate` (the SAD and MC
kernels on CUDA).  The stream holds `f%04d.<segment>` sub-streams,
`mv_%04d` arrays and the payload JSON with `"generic": true`.  The still
codec's decode filter, if any, runs inside the loop, as in vcf_tpu.

With a `mesh` (a `parallel.Mesh` whose first device is the codec's), the
fused loop's GOPs are sharded as vcf_tpu's `_shard_gops` shards them:
the GOP batch padded to a multiple of the mesh size by repeating its
last GOP, each shard's GOPs run through the frame loop on its own device,
and the outputs gathered in GOP order on the codec's device and cut to
the clip's GOPs, at encode and at decode.  The entropy stage and the
generic closed loop are not sharded, as in vcf_tpu.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from vcf_tpu_torch import entropy
from vcf_tpu_torch.codestream import CodeStream, PAYLOAD
from vcf_tpu_torch.config import CodecConfig, VideoConfig
from vcf_tpu_torch.ops import color as color_ops
from vcf_tpu_torch.ops import dct as dct_ops
from vcf_tpu_torch.ops import motion
from vcf_tpu_torch.ops import quantize as q_ops
from vcf_tpu_torch.ops.cuda import dct_kernel as dk
from vcf_tpu_torch.ops.cuda import luma_kernel, mc_kernel
from vcf_tpu_torch.ops.cuda import sad_kernel
from vcf_tpu_torch.parallel.mesh import (Mesh, check_mesh, gather, pad_to,
                                         shard_batch)
from vcf_tpu_torch.pipeline import Codec, check_full_fp32
from vcf_tpu_torch.utils import profiling
from vcf_tpu_torch.video.iii import BATCHED_ENTROPY

# residuals and indexes are shifted by 128 (src/IPP_DCT.py:550-560)
_OFF = 128


def _clip(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 255.0)


def _residual(cur: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """clip(cur - pred + 128), in a `vcf.ipp.pixels` span."""
    with profiling.span("vcf.ipp.pixels"):
        return _clip(cur - pred + 128.0)


def _reconstruct(pred: torch.Tensor, rec: torch.Tensor) -> torch.Tensor:
    """clip(pred + rec - 128), in a `vcf.ipp.pixels` span.  Each
    temporary is freed where the one expression frees it (rec at the add,
    unless the caller holds it), so the card's allocator sees the same
    order of allocations and frees as without the span."""
    with profiling.span("vcf.ipp.pixels"):
        x = pred + rec
        del rec
        x = x - 128.0
        return _clip(x)


def _stack_frames(frames: List[torch.Tensor]) -> torch.Tensor:
    """torch.stack(frames, 1), its bytes read and written counted in
    `layout_bytes`."""
    out = torch.stack(frames, 1)
    profiling.count("layout_bytes", 2 * out.nbytes)
    return out


class IPPCodec:
    """IPP on one torch device (or the fused loop sharded over a mesh):
    the fused GOP loop for the dct + deadzone compositions, the generic
    closed loop through the still `Codec` for every other one."""

    def __init__(self, video_config: VideoConfig, codec_config: CodecConfig,
                 device, mesh=None):
        self.vcfg = video_config
        self.ccfg = codec_config
        self.device = torch.device(device)
        check_mesh(mesh, self.device)
        #: the fused loop's GOPs shard over it (None: all on `device`)
        self.mesh = mesh
        if self.device.type == "cuda":
            check_full_fp32()
        self.entropy_codec = entropy.get(codec_config.entropy, codec_config,
                                         self.device)
        #: the fused GOP loop (vcf_tpu ipp.py:56-62), else the generic one
        self.fused = (codec_config.spatial == "dct"
                      and codec_config.quantizer == "deadzone")
        self.still = None if self.fused else Codec(codec_config, self.device)
        cname = "ycocg" if codec_config.color == "ycocg_r" else codec_config.color
        self._mats = color_ops.MATRICES.get(cname)       # None: color "none"
        #: the planar subband-grid loop (fused and ycocg), else None as in
        #: vcf_tpu
        self._gop_encode_grid_batch = self._gop_decode_grid_batch = None
        if self.fused and codec_config.color == "ycocg":
            (self._gop_encode_grid_batch,
             self._gop_decode_grid_batch) = self._build_planar_gop()
        #: the encoder's reconstruction (G, T, 3, H, W) float32 of the last
        #: `_gop_encode_grid_batch` call, which the grid decode reproduces
        self.last_grid_recon = None
        #: of the last encode: the stored (n, H, W, 3) uint8 index planes
        #: (numpy), and the closed-loop reconstruction, an (n, H, W, 3)
        #: float32 tensor left on the device (no copy to the host), which
        #: `decode` must reproduce bit for bit
        self.last_planes = None
        self.last_recon = None

    def _shard_gops(self, gops: np.ndarray) -> List[torch.Tensor]:
        """A batch of GOPs (or of their mvs or modes) -> one tensor per
        shard on its device, padded to a multiple of the mesh size by
        repeating the last GOP (GOPs are independent: no collective)."""
        mesh = self.mesh if self.mesh is not None else Mesh((self.device,))
        return shard_batch(pad_to(gops, mesh.size)[0], mesh)

    # ------------------------------------------------------------------
    # Routes
    # ------------------------------------------------------------------
    def _make_search(self, h: int, w: int):
        """Motion search for (G, h, w) lumas, tagged with `.kind`:
        "three_step" when `fast_search` is set; "sad_search" (the kernel
        on CUDA, its plain version on the CPU; vcf_tpu's "pallas_sad" and
        "pallas_sad_tiled") when `use_pallas` is set, h, w are multiples
        of the block and the kernel takes the range on this device
        (`sad_kernel.fits`: on the CPU the first kernel design's gate, on
        CUDA every range); else "full_search" (vcf_tpu's "lax_full").
        The route follows the shape alone; both searches are exact, so it
        never changes a stream (ROADMAP C6, C12)."""
        m, s = self.vcfg.me_block, self.vcfg.search_range

        def tagged(kind, fn):
            fn.kind = kind
            return fn

        if self.vcfg.fast_search:
            return tagged("three_step",
                          lambda r, c: motion.three_step_search(r, c, m, s))
        if (self.ccfg.use_pallas and h % m == 0 and w % m == 0
                and sad_kernel.fits(m, s, self.device)):
            return tagged("sad_search",
                          lambda r, c: sad_kernel.sad_search(r, c, m, s))
        return tagged("full_search",
                      lambda r, c: motion.full_search(r, c, m, s))

    def _compensate(self, ref: torch.Tensor, mv: torch.Tensor, m=None,
                    s=None) -> torch.Tensor:
        """(G, 3, H, W) reference -> prediction for (G, nby, nbx, 2) mvs of
        block m and range s (default: the codec's)."""
        m = self.vcfg.me_block if m is None else m
        s = self.vcfg.search_range if s is None else s
        if self.ccfg.use_pallas:
            return mc_kernel.mc_apply_planar(ref, mv, m)
        return motion.compensate(ref.movedim(-3, -1), mv, m,
                                 pad=max(s, 8)).movedim(-1, -3)

    def _enc(self, img: torch.Tensor) -> torch.Tensor:
        """(G, 3, H, W) float32 pixels -> (G, 3, H, W) uint8 indexes in
        block layout (the subband order is applied on storage)."""
        cfg = self.ccfg
        b, qss = cfg.block_size, cfg.qss
        ct = img - 128.0
        if self._mats is not None:
            ct = color_ops.fma_rows(ct, self._mats[0], axis=-3)
        if cfg.use_pallas:
            return dk.fused_dct_quantize(ct.contiguous(), b=b, qss=qss,
                                         offset=_OFF)
        coeff = dct_ops.analyze(ct.movedim(-3, -1), b)
        k = q_ops.deadzone_quantize(coeff, qss)
        # saturate, not wrap (Deadzone_Quantizer min/max, src/deadzone.py:64)
        return torch.clamp(k + _OFF, 0, 255).to(torch.uint8).movedim(-1, -3)

    def _dec(self, k_u8: torch.Tensor) -> torch.Tensor:
        """(G, 3, H, W) uint8 block-layout indexes -> float32 pixels,
        rounded half to even and clipped to [0, 255]."""
        cfg = self.ccfg
        b, qss = cfg.block_size, cfg.qss
        if cfg.use_pallas:
            ct = dk.fused_dequantize_idct(k_u8.contiguous(), b=b, qss=qss,
                                          offset=_OFF)
        else:
            coeff = q_ops.deadzone_dequantize(
                k_u8.movedim(-3, -1).to(torch.int32) - _OFF, qss)
            ct = dct_ops.synthesize(coeff, b).movedim(-1, -3)
        if self._mats is not None:
            ct = color_ops.fma_rows(ct, self._mats[1], axis=-3)
        return _clip(torch.round(ct + 128.0))

    def _store(self, k: torch.Tensor) -> torch.Tensor:
        """(..., 3, H, W) block-layout indexes -> stored (..., H, W, 3)."""
        k = k.movedim(-3, -1)
        if self.ccfg.subbands:
            k = dct_ops.to_subbands(k, self.ccfg.block_size)
        return k.contiguous()

    def _load(self, planes: torch.Tensor) -> torch.Tensor:
        """Stored (..., H, W, 3) planes -> (..., 3, H, W) block layout."""
        if self.ccfg.subbands:
            planes = dct_ops.from_subbands(planes, self.ccfg.block_size)
        return planes.movedim(-1, -3).contiguous()

    # ------------------------------------------------------------------
    # RDO (src/IPP_DCT.py:265-342): cost = D + lambda * R per block on luma,
    # the rate modeled as sum(log2(|k| + 1) + 1) bits per coefficient
    # ------------------------------------------------------------------
    def _block_cost(self, blocks: torch.Tensor):
        """(..., m, m) pixel blocks -> (distortion, rate) per block."""
        m, qss = self.vcfg.me_block, self.ccfg.qss
        d = torch.from_numpy(dct_ops.dct_matrix(m)).to(blocks.device)
        c = torch.einsum("ur,...rs->...us", d, blocks)
        c = torch.einsum("vs,...us->...uv", d, c)
        k = q_ops.deadzone_quantize(c, qss)
        y = q_ops.deadzone_dequantize(k, qss)
        dist = ((y - c) ** 2).sum(dim=(-2, -1))
        rate = (torch.log2(k.abs().to(torch.float32) + 1.0) + 1.0).sum(
            dim=(-2, -1))
        return dist, rate

    def _rdo_modes(self, cur_l: torch.Tensor, pred_l: torch.Tensor):
        """(G, H, W) lumas -> (G, nby, nbx) bool, True = inter."""
        m, lam = self.vcfg.me_block, self.vcfg.rdo_lambda
        g, h, w = cur_l.shape

        def blocks(x):
            return x.reshape(g, h // m, m, w // m, m).transpose(2, 3)

        d_i, r_i = self._block_cost(blocks(cur_l - 128.0))
        d_p, r_p = self._block_cost(blocks(cur_l - pred_l))
        return (d_p + lam * r_p) <= (d_i + lam * r_i)

    def _mask(self, inter: torch.Tensor) -> torch.Tensor:
        """(G, nby, nbx) block modes -> (G, 1, H, W) pixel mask."""
        m = self.vcfg.me_block
        return inter.repeat_interleave(m, 1).repeat_interleave(m, 2)[:, None]

    # ------------------------------------------------------------------
    # GOP loops: GOPs are the batch dimension, the P chain a loop over t
    # ------------------------------------------------------------------
    def _gop_encode(self, gops: torch.Tensor):
        """(G, T, H, W, 3) uint8 -> (block-layout planes (G, T, 3, H, W)
        uint8, mvs (G, T-1, nby, nbx, 2) int32, modes (G, T-1, nby, nbx)
        bool or None, reconstruction (G, T, 3, H, W) float32)."""
        rdo = self.vcfg.rdo_lambda != 0
        frames = gops.permute(0, 1, 4, 2, 3)              # (G, T, 3, H, W)
        k = self._enc(frames[:, 0].to(torch.float32))
        ref = self._dec(k)
        ks, recs, mvs, modes = [k], [ref], [], []
        for t in range(1, gops.shape[1]):
            cur = frames[:, t].to(torch.float32)
            ref_l = motion.to_luma(_clip(torch.round(ref)).to(torch.uint8),
                                   channel_axis=-3)
            cur_l = motion.to_luma(gops[:, t])
            mv, _ = self._make_search(*cur_l.shape[-2:])(ref_l, cur_l)
            pred = self._compensate(ref, mv)
            residual = _clip(cur - pred + 128.0)
            if rdo:
                pred_l = motion.to_luma(
                    _clip(torch.round(pred)).to(torch.uint8), channel_axis=-3)
                inter = self._rdo_modes(cur_l, pred_l)
                mask = self._mask(inter)
                k = self._enc(torch.where(mask, residual, cur))
                rec_mixed = self._dec(k)
                ref = torch.where(mask, _clip(pred + rec_mixed - 128.0),
                                  rec_mixed)
                modes.append(inter)
            else:
                k = self._enc(residual)
                ref = _clip(pred + self._dec(k) - 128.0)
            ks.append(k)
            recs.append(ref)
            mvs.append(mv)
        mvs_t = self._stack_mvs(mvs, gops)           # gop_size 1: no P frame
        modes_t = None
        if rdo:
            modes_t = (torch.stack(modes, 1) if modes
                       else mvs_t[..., 0].to(torch.bool))
        return torch.stack(ks, 1), mvs_t, modes_t, torch.stack(recs, 1)

    def _gop_decode(self, planes: torch.Tensor, mvs: torch.Tensor,
                    modes=None, dec=None) -> torch.Tensor:
        """Block-layout planes (G, T, 3, H, W) uint8, mvs (G, T-1, nby,
        nbx, 2), modes (G, T-1, nby, nbx) or None -> (G, T, 3, H, W)
        float32 reconstruction.  `dec` decodes one frame's planes (default
        self._dec; the planar grid loop passes its B4 grid decode)."""
        dec = dec or self._dec
        ref = dec(planes[:, 0])
        recs = [ref]
        for t in range(1, planes.shape[1]):
            pred = self._compensate(ref, mvs[:, t - 1])
            rec = dec(planes[:, t])
            if modes is None:
                ref = _reconstruct(pred, rec)
            else:
                with profiling.span("vcf.ipp.pixels"):
                    ref = torch.where(self._mask(modes[:, t - 1]),
                                      _reconstruct(pred, rec), rec)
            recs.append(ref)
        with profiling.span("vcf.ipp.layout"):
            return _stack_frames(recs)

    def _build_planar_gop(self):
        """(gop_encode_planar, gop_decode_planar): vcf_tpu's planar
        subband-grid closed loop over a GOP batch.  Pixels stay (G, 3, H,
        W) float32 holding integers, so the u8 cast at B3 is exact; the
        index planes come out of B3 in the grid layout and go back into
        B4 in it."""
        b, qss = self.ccfg.block_size, self.ccfg.qss
        mf = dk.static_mat(color_ops.YCOCG_FWD)
        mi = dk.static_mat(color_ops.YCOCG_INV)

        def enc_p(img):
            with profiling.span("vcf.ipp.pixels"):
                pixels = img.to(torch.uint8)
            return dk.fused_cdct_quantize(pixels, mf, b=b, qss=qss,
                                          offset=_OFF, grid_layout=True)

        def dec_p(k):
            rec = dk.fused_dequantize_cdct(k, mi, b=b, qss=qss, offset=_OFF,
                                           grid_layout=True)
            with profiling.span("vcf.ipp.pixels"):
                return rec.to(torch.float32)

        def gop_encode_planar(gops: torch.Tensor):
            """(G, T, H, W, 3) uint8 -> (planes (G, T, 3, H, W) uint8 in
            the grid layout, mvs (G, T-1, nby, nbx, 2) int32)."""
            with profiling.span("vcf.ipp.encode"):
                with profiling.span("vcf.ipp.pixels"):
                    frames = gops.permute(0, 1, 4, 2, 3).to(torch.float32)
                k = enc_p(frames[:, 0])
                ref = dec_p(k)
                ks, recs, mvs = [k], [ref], []
                for t in range(1, gops.shape[1]):
                    cur = frames[:, t]
                    with profiling.span("vcf.ipp.luma"):
                        # vcf_tpu's planar luma: round(ref), no clip, no u8
                        # cast; cur's from the u8 clip, the same integers
                        ref_l = luma_kernel.luma(ref, -3, round=True)
                        cur_l = luma_kernel.luma(gops[:, t], -1)
                    mv, _ = self._make_search(*cur_l.shape[-2:])(ref_l, cur_l)
                    pred = self._compensate(ref, mv)
                    # the residual and the decode stay temporaries
                    k = enc_p(_residual(cur, pred))
                    ref = _reconstruct(pred, dec_p(k))
                    ks.append(k)
                    recs.append(ref)
                    mvs.append(mv)
                with profiling.span("vcf.ipp.layout"):
                    self.last_grid_recon = _stack_frames(recs)
                    planes = _stack_frames(ks)
                return planes, self._stack_mvs(mvs, gops)

        def gop_decode_planar(planes: torch.Tensor, mvs: torch.Tensor,
                              modes=None):
            """Grid-layout planes (G, T, 3, H, W) uint8 and mvs -> (G, T,
            3, H, W) float32 reconstruction."""
            with profiling.span("vcf.ipp.decode"):
                return self._gop_decode(planes, mvs, modes, dec=dec_p)

        return gop_encode_planar, gop_decode_planar

    def _stack_mvs(self, mvs: List[torch.Tensor], gops: torch.Tensor
                   ) -> torch.Tensor:
        """The P frames' (G, nby, nbx, 2) mvs -> (G, T-1, nby, nbx, 2);
        (G, 0, nby, nbx, 2) int32 for GOPs of one frame."""
        if mvs:
            return torch.stack(mvs, 1)
        m = self.vcfg.me_block
        g, _, h, w, _ = gops.shape
        return torch.zeros((g, 0, h // m, w // m, 2), dtype=torch.int32,
                           device=gops.device)

    # ------------------------------------------------------------------
    def encode(self, frames: np.ndarray) -> CodeStream:
        vcfg = self.vcfg
        frames = np.asarray(frames)[: vcfg.n_frames]
        n, h, w, _ = frames.shape
        b = self.ccfg.block_size
        if h % b or w % b:
            raise ValueError(
                f"IPP frames must be multiples of the DCT block size {b}")
        m = vcfg.me_block
        if h % m or w % m:
            raise ValueError(f"frame size must be a multiple of ME block {m}")
        if not self.fused:
            return self._encode_generic(frames)

        t = vcfg.gop_size
        n_pad = (-n) % t
        padded = frames
        if n_pad:
            padded = np.concatenate([frames, np.repeat(frames[-1:], n_pad, 0)])
        gops = padded.reshape(-1, t, *frames.shape[1:])
        n_gops = gops.shape[0]
        outs = [self._gop_encode(g) for g in self._shard_gops(gops)]
        planes_b, mvs_b, modes_b, recs = (
            None if outs[0][i] is None
            else gather([o[i] for o in outs], self.device)[:n_gops]
            for i in range(4))
        planes_np = self._store(planes_b).reshape(-1, h, w, 3)[:n].cpu().numpy()
        mvs_np = mvs_b.cpu().numpy()                 # (G, T-1, nby, nbx, 2)
        modes_np = None if modes_b is None else modes_b.cpu().numpy()
        self.last_planes = planes_np
        self.last_recon = recs.movedim(-3, -1).reshape(-1, h, w, 3)[:n]

        kinds: List[str] = []
        mvs: Dict[str, np.ndarray] = {}
        modes: Dict[str, np.ndarray] = {}
        for i in range(n):
            if i % t == 0:
                kinds.append("I")
            else:
                kinds.append("P")
                mvs[f"mv_{i:04d}"] = mvs_np[i // t, i % t - 1]
                if modes_np is not None:
                    modes[f"modes_{i:04d}"] = modes_np[i // t, i % t - 1]

        cs = CodeStream()
        batched = self.ccfg.entropy in BATCHED_ENTROPY
        if batched:
            # every index plane (I and P residual) in one entropy call
            payload, side = self.entropy_codec.encode(planes_np)
            cs["clip.payload"] = payload
            for name, blob in side.items():
                cs[f"clip.{name}"] = blob
        else:
            for i, plane in enumerate(planes_np):
                payload, side = self.entropy_codec.encode(plane)
                cs[f"f{i:04d}"] = payload
                for name, blob in side.items():
                    cs[f"f{i:04d}.{name}"] = blob
        for name, arr in {**mvs, **modes}.items():
            cs.put_array(name, arr)
        cs.put_json(PAYLOAD, {
            "mode": "ipp", "n_frames": int(n), "kinds": kinds,
            "frame_shape": [int(s) for s in frames.shape[1:]],
            "gop": vcfg.gop_size, "me_block": m,
            "search_range": vcfg.search_range,
            "rdo": vcfg.rdo_lambda,
            "batched": bool(batched),
        })
        return cs

    # ------------------------------------------------------------------
    def decode(self, cs: CodeStream) -> np.ndarray:
        meta = cs.get_json(PAYLOAD)
        if meta.get("generic"):
            return self._decode_generic(cs)
        n = meta["n_frames"]
        kinds = meta["kinds"]
        m = meta["me_block"]
        rdo = meta.get("rdo", 0)

        if meta.get("batched"):
            side = {
                name[len("clip."):]: cs[name]
                for name in cs
                if name.startswith("clip.") and name != "clip.payload"
            }
            planes_np = np.asarray(
                self.entropy_codec.decode(cs["clip.payload"], side))
        else:
            planes = []
            for i in range(n):
                side = {
                    name.split(".", 1)[1]: cs[name]
                    for name in cs
                    if name.startswith(f"f{i:04d}.")
                }
                planes.append(self.entropy_codec.decode(cs[f"f{i:04d}"], side))
            planes_np = np.stack(planes)

        t = meta["gop"]
        n_pad = (-n) % t
        if n_pad:
            planes_np = np.concatenate(
                [planes_np, np.repeat(planes_np[-1:], n_pad, 0)])
        h, w = planes_np.shape[1:3]
        nby, nbx = h // m, w // m
        mv_all = np.zeros((planes_np.shape[0], nby, nbx, 2), np.int32)
        mode_all = np.zeros((planes_np.shape[0], nby, nbx), bool)
        for i in range(n):
            if kinds[i] == "P":
                mv_all[i] = cs.get_array(f"mv_{i:04d}")
                if rdo:
                    mode_all[i] = cs.get_array(f"modes_{i:04d}")
        gops = planes_np.reshape(-1, t, *planes_np.shape[1:])
        planes_t = [self._load(p) for p in self._shard_gops(gops)]
        mvs_t = self._shard_gops(mv_all.reshape(-1, t, nby, nbx, 2)[:, 1:])
        modes_t = [None] * len(planes_t)
        if rdo:
            modes_t = self._shard_gops(
                mode_all.reshape(-1, t, nby, nbx)[:, 1:])
        recs = gather([self._gop_decode(p, mv, md) for p, mv, md
                       in zip(planes_t, mvs_t, modes_t)], self.device)
        recs = recs[:gops.shape[0]].movedim(-3, -1).reshape(-1, h, w, 3)[:n]
        return recs.to(torch.uint8).cpu().numpy()

    # ------------------------------------------------------------------
    # Generic closed loop through the still Codec (vcf_tpu ipp.py:601-667)
    # ------------------------------------------------------------------
    def _upload(self, frame: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(frame)).to(self.device)

    def _predict(self, ref: torch.Tensor, mv: torch.Tensor, m: int, s: int
                 ) -> torch.Tensor:
        """(H, W, 3) uint8 reference, (nby, nbx, 2) mvs -> the (H, W, 3)
        float32 prediction (`_compensate` on a batch of one)."""
        planar = ref.to(torch.float32).permute(2, 0, 1)[None].contiguous()
        return self._compensate(planar, mv[None], m, s)[0].permute(1, 2, 0)

    def _encode_generic(self, frames: np.ndarray) -> CodeStream:
        vcfg = self.vcfg
        m, s = vcfg.me_block, vcfg.search_range
        n, h, w, _ = frames.shape
        search = self._make_search(h, w)
        cs = CodeStream()
        kinds: List[str] = []
        recons = []
        ref = None
        for i in range(n):
            if i % vcfg.gop_size == 0:
                sub = self.still.encode(frames[i])
                recon = self.still.decode(sub)
                kinds.append("I")
            else:
                cur = self._upload(frames[i])
                ref_t = self._upload(ref)
                mv, _ = search(motion.to_luma(ref_t), motion.to_luma(cur))
                pred = self._predict(ref_t, mv, m, s)
                # clip, then truncate to u8 (vcf_tpu ipp.py:623)
                residual = _clip(cur.to(torch.float32) - pred + 128.0).to(
                    torch.uint8).cpu().numpy()
                sub = self.still.encode(residual)
                res_rec = self._upload(self.still.decode(sub)).to(
                    torch.float32) - 128.0
                recon = _clip(pred + res_rec).to(torch.uint8).cpu().numpy()
                cs.put_array(f"mv_{i:04d}", mv.cpu().numpy().astype(np.int32))
                kinds.append("P")
            for name, blob in sub.items():
                cs[f"f{i:04d}.{name}"] = blob
            recons.append(recon)
            ref = recon
        cs.put_json(PAYLOAD, {
            "mode": "ipp", "generic": True, "n_frames": int(n), "kinds": kinds,
            "frame_shape": [int(v) for v in frames.shape[1:]],
            "gop": vcfg.gop_size, "me_block": m, "search_range": s,
            "rdo": 0,
        })
        self.last_planes = None
        self.last_recon = self._upload(np.stack(recons)).to(torch.float32)
        return cs

    def _decode_generic(self, cs: CodeStream) -> np.ndarray:
        meta = cs.get_json(PAYLOAD)
        kinds = meta["kinds"]
        m, s = meta["me_block"], meta["search_range"]
        out = []
        ref = None
        for i in range(meta["n_frames"]):
            prefix = f"f{i:04d}."
            sub = CodeStream()
            for name in cs:
                if name.startswith(prefix):
                    sub[name[len(prefix):]] = cs[name]
            dec = self.still.decode(sub)
            if kinds[i] == "I":
                recon = dec
            else:
                mv = self._upload(cs.get_array(f"mv_{i:04d}"))
                pred = self._predict(self._upload(ref), mv, m, s)
                recon = _clip(pred + self._upload(dec).to(torch.float32)
                              - 128.0).to(torch.uint8).cpu().numpy()
            out.append(recon)
            ref = recon
        return np.stack(out)
