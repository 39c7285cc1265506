"""Batch codec on one torch device (port of vcf_tpu/parallel/mesh.py,
`BatchCodec`).

vcf_tpu vmaps the per-frame device work over the frame axis and shards
the frames over a mesh with shard_map.  Here the frame axis is a tensor
batch dimension on one device, and one kernel launch covers the clip.
The mesh, `make_mesh`/`shard_batch` and the multi-device split wait for
ROADMAP A15.

Routes, chosen once from the config as vcf_tpu's `_build` chooses them:

* ``use_pallas`` and a linear color (ycocg, ycocg_r -> ycocg, ycrcb,
  cdct) without perceptual scaling: the color-fused kernels
  `fused_cdct_quantize` / `fused_dequantize_cdct` (B3/B4), u8 -> u8;
* ``use_pallas`` otherwise (``color="none"``, perceptual): the color
  transform in torch around `fused_dct_quantize` /
  `fused_dequantize_idct` (B1/B2);
* ``use_pallas=False``: the unfused torch route, the counterpart of
  vcf_tpu's XLA branch;
* the Lloyd-Max quantizer: the per-frame `Codec`'s own torch transform
  and quantizer, frame by frame (vcf_tpu vmaps the same plain XLA
  functions, mesh.py:237-249; no fused kernel quantizes to trained
  levels), so per-frame levels and indexes equal the per-frame `Codec`'s
  bit for bit.  ``shared_levels=True`` trains one level set from the
  batch's summed raw histogram instead (vcf_tpu psums it over the mesh).

On a CPU device the kernel routes run the kernels' plain torch versions;
on CUDA they launch the kernels.  The TPU's shape gates (`supports`,
32-row / 128-lane tiles) have no counterpart: the kernels take any
block-multiple frame.  Subband order is applied to the kernels' block
layout outside them, as vcf_tpu does.  The kernels are planar, so each
direction transposes (N, H, W, 3) <-> (N, 3, H, W) with a full copy.

Indexes saturate to [0, 255] on the kernel routes (src/deadzone.py:64)
and wrap through uint8 on the torch route, as on vcf_tpu's two routes
(ROADMAP C4).
"""

from __future__ import annotations

import numpy as np
import torch

from vcf_tpu_torch.config import CodecConfig
from vcf_tpu_torch.ops import color as color_ops
from vcf_tpu_torch.ops import dct as dct_ops
from vcf_tpu_torch.ops import quantize as q_ops
from vcf_tpu_torch.ops.cuda import dct_kernel as dk
from vcf_tpu_torch.pipeline import Codec, check_full_fp32


def _on_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint8 array -> tensor on `device`, keeping numpy's strides: a
    channel-planar (N, H, W, 3) array uploads as it lies, with no
    transposing copy on the host (torch.from_numpy takes any strides
    but negative ones)."""
    arr = np.asarray(arr, np.uint8)
    if any(st < 0 for st in arr.strides):
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


# the deadzone flow subtracts 128 before the transform and adds it to the
# indexes (src/2D-DCT.py:107-110)
_SOFF = 128


class BatchCodec:
    """Encode/decode of a batch of frames (N, H, W, 3) on one device.

    Device work (color transform + block DCT + quantize) runs on the
    whole batch at once; entropy coding of the index planes is the
    caller's (see `vcf_tpu_torch.video.IIICodec`)."""

    def __init__(self, config: CodecConfig, device,
                 shared_levels: bool = False):
        if (config.spatial != "dct"
                or config.quantizer not in ("deadzone", "lloydmax")):
            raise NotImplementedError(
                "BatchCodec supports the dct+deadzone/lloydmax flows; "
                "use vcf_tpu_torch.Codec per frame for other compositions")
        self.config = config
        self.device = torch.device(device)
        if self.device.type == "cuda":
            check_full_fp32()
        #: lloydmax only: train ONE level set from the batch's summed raw
        #: histogram (the reference's one-table-per-source semantics,
        #: src/LloydMax.py:107-112); False trains per-frame levels, equal
        #: to the per-frame `Codec`'s
        self.shared_levels = bool(shared_levels)
        #: side info of the last encode: {"levels": (N, C, L) or (C, L)}
        self.last_qside: dict = {}
        cname = "ycocg" if config.color == "ycocg_r" else config.color
        self._fwd, self._inv = color_ops.get(cname)
        mats = None if config.perceptual else color_ops.MATRICES.get(cname)
        if config.quantizer == "lloydmax":
            self.route = "lloydmax"
            self._still = Codec(config, self.device)
        elif not config.use_pallas:
            self.route = "torch"
        elif mats is not None:
            self.route = "cdct"
            self._mf, self._mi = dk.static_mat(mats[0]), dk.static_mat(mats[1])
        else:
            self.route = "planes"

    # ------------------------------------------------------------------
    def _encode(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) uint8 on the device -> (N, H, W, 3) uint8 indexes
        in the config's layout."""
        cfg, b, soff = self.config, self.config.block_size, _SOFF
        if self.route == "torch":
            coeff = dct_ops.analyze(self._fwd(x.to(torch.float32) - soff), b)
            if cfg.perceptual:
                coeff = dct_ops.perceptual_scale(coeff, b)
            if cfg.subbands:
                coeff = dct_ops.to_subbands(coeff, b)
            k = q_ops.deadzone_quantize(coeff, cfg.qss)
            return (k + soff).to(torch.uint8)          # wraps, as XLA's cast
        if self.route == "cdct":
            k = dk.fused_cdct_quantize(x.permute(0, 3, 1, 2).contiguous(),
                                       self._mf, b=b, qss=cfg.qss,
                                       offset=soff)
        else:
            ct = self._fwd(x.to(torch.float32) - soff)
            k = dk.fused_dct_quantize(ct.permute(0, 3, 1, 2).contiguous(),
                                      b=b, qss=cfg.qss, offset=soff,
                                      perceptual=cfg.perceptual)
        k = k.permute(0, 2, 3, 1)
        # a pure permutation of stored indexes: commutes with quantization
        return (dct_ops.to_subbands(k, b) if cfg.subbands
                else k.contiguous())

    def _decode(self, k_u8: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) uint8 indexes on the device -> uint8 frames."""
        cfg, b, soff = self.config, self.config.block_size, _SOFF
        if self.route == "torch":
            coeff = q_ops.deadzone_dequantize(k_u8.to(torch.int32) - soff,
                                              cfg.qss)
            if cfg.subbands:
                coeff = dct_ops.from_subbands(coeff, b)
            if cfg.perceptual:
                coeff = dct_ops.perceptual_scale(coeff, b, inverse=True)
            y = self._inv(dct_ops.synthesize(coeff, b)) + soff
            return torch.clamp(torch.round(y), 0, 255).to(torch.uint8)
        if cfg.subbands:
            k_u8 = dct_ops.from_subbands(k_u8, b)
        planes = k_u8.permute(0, 3, 1, 2).contiguous()
        if self.route == "cdct":
            pix = dk.fused_dequantize_cdct(planes, self._mi, b=b, qss=cfg.qss,
                                           offset=soff)
            return pix.permute(0, 2, 3, 1).contiguous()
        ct = dk.fused_dequantize_idct(planes, b=b, qss=cfg.qss, offset=soff,
                                      perceptual=cfg.perceptual)
        y = self._inv(ct.permute(0, 2, 3, 1)) + soff
        return torch.clamp(torch.round(y), 0, 255).to(torch.uint8)

    # ------------------------------------------------------------------
    def _encode_lloydmax(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) uint8 -> uint8 Lloyd-Max indexes (wrapping through
        uint8 as vcf_tpu's cast, ROADMAP C4); sets `last_qside`."""
        cfg, still = self.config, self._still
        coeff = torch.stack([still._analyze(f.to(torch.float32)) for f in x])
        n, c = coeff.shape[0], coeff.shape[-1]
        # per frame: the frames' channels as the rows of one (N * C, V)
        # histogram, trained row by row as the per-frame Codec trains
        per_frame = coeff.permute(1, 2, 0, 3).reshape(-1, n * c)
        hist = q_ops.lloydmax_histogram(
            torch.round(per_frame).to(torch.int32), cfg.q_min, cfg.q_max)
        if self.shared_levels:
            hist = hist.reshape(n, c, -1).sum(dim=0)
            levels = q_ops.lloydmax_train_from_hist(hist, cfg.qss, cfg.q_min,
                                                    cfg.q_max)
            k = q_ops.lloydmax_quantize(coeff, levels)
        else:
            levels = q_ops.lloydmax_train_from_hist(hist, cfg.qss, cfg.q_min,
                                                    cfg.q_max)
            k = q_ops.lloydmax_quantize(per_frame, levels)
            k = k.reshape(coeff.shape[1], coeff.shape[2], n, c).permute(
                2, 0, 1, 3)
            levels = levels.reshape(n, c, -1)
        self.last_qside = {"levels": levels.cpu().numpy()}
        return k.to(torch.uint8)

    def _decode_lloydmax(self, k_u8: torch.Tensor, levels) -> torch.Tensor:
        """uint8 Lloyd-Max indexes + (N, C, L) or shared (C, L) levels ->
        uint8 frames, frame by frame as the per-frame Codec decodes."""
        lv = torch.from_numpy(np.asarray(levels, np.float32)).to(self.device)
        out = []
        for i, k in enumerate(k_u8):
            coeff = q_ops.lloydmax_dequantize(k.to(torch.int32),
                                              lv[i] if lv.dim() == 3 else lv)
            y = self._still._synthesize(coeff)
            out.append(torch.clamp(torch.round(y), 0, 255).to(torch.uint8))
        return torch.stack(out)

    def encode_planes(self, frames: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) uint8 -> (N, Hp, Wp, 3) uint8 index planes."""
        b = self.config.block_size
        x = _on_device(frames, self.device)
        if x.shape[1] % b or x.shape[2] % b:
            x = torch.stack([dct_ops.pad_centered(f, b) for f in x])
        if self.route == "lloydmax":
            return self._encode_lloydmax(x).cpu().numpy()
        return self._encode(x).cpu().numpy()

    def decode_planes(self, planes: np.ndarray, original_hw=None,
                      qside=None) -> np.ndarray:
        """(N, Hp, Wp, 3) uint8 index planes -> (N, H, W, 3) uint8 frames,
        cropped (centered) to `original_hw` when given.  `qside` is the
        Lloyd-Max side info (default: the last encode's), unused by
        deadzone."""
        k = _on_device(planes, self.device)
        if self.route == "lloydmax":
            side = qside if qside is not None else self.last_qside
            frames = self._decode_lloydmax(k, side["levels"])
        else:
            frames = self._decode(k)
        if original_hw is not None and tuple(frames.shape[1:3]) != tuple(
                original_hw):
            h, w = original_hw
            top = (frames.shape[1] - h) // 2
            left = (frames.shape[2] - w) // 2
            frames = frames[:, top:top + h, left:left + w].contiguous()
        return frames.cpu().numpy()
