"""Codec pipeline (port of vcf_tpu/pipeline.py, the ported flows).

A `Codec` is built from a `CodecConfig` and an explicit torch device.
The ported flows are the block-DCT spatial pipeline with the deadzone
quantizer (color transform -> 8x8 block DCT -> optional perceptual
prescale -> subband order -> deadzone -> entropy; src/2D-DCT.py
encode_fn/decode_fn), the DWT spatial pipeline with the deadzone
quantizer (`ops.dwt.DWT`; src/2D-DWT.py) and the entropy-only flow.
Every other flow raises NotImplementedError when the `Codec` is built,
naming its ROADMAP queue-A item.

The pixel math runs on the device as torch ops; the entropy codec gets
the uint8 index planes and runs on the same device where it can (`rans`,
`grans`) or on the host (`tiff`, `zlib`).  On CUDA the codec refuses to
run with TF32 matmuls: float32 means float32, the counterpart of
vcf_tpu's Precision.HIGHEST.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from vcf_tpu_torch import entropy
from vcf_tpu_torch.codestream import CodeStream, PAYLOAD
from vcf_tpu_torch.config import CodecConfig
from vcf_tpu_torch.ops import color as color_ops
from vcf_tpu_torch.ops import dct as dct_ops
from vcf_tpu_torch.ops import dwt as dwt_ops
from vcf_tpu_torch.ops import quantize as q_ops
from vcf_tpu_torch.utils.timing import StageTimer, timed_stage


def _not_ported(cfg: CodecConfig):
    """(what, ROADMAP item) of the first unported part of `cfg`, or None."""
    if cfg.quantizer == "colorvq":
        return "the colorvq flow", "A11"
    if cfg.filter != "none":
        return f"the {cfg.filter} decode filter", "A13"
    if cfg.spatial in ("klt", "mdct", "lbt"):
        return f"the {cfg.spatial} flow", "A12"
    if cfg.spatial in ("dct", "dwt"):
        if cfg.quantizer in ("lloydmax", "vq"):
            return f"the {cfg.quantizer} quantizer", "A11"
        if cfg.quantizer != "deadzone":
            return f"the {cfg.spatial} flow without a quantizer", "A17"
        return None
    if cfg.color != "none":
        return "the color-only flow", "A17"
    if cfg.quantizer != "none":
        return "the quantize-only flow", "A17"
    return None


def check_full_fp32() -> None:
    """Raise unless CUDA float32 matmuls run in full float32 (no TF32)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 must be False")
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError('torch.get_float32_matmul_precision() must be '
                           '"highest"')


class Codec:
    """Still-image codec for one `CodecConfig` on one torch device."""

    def __init__(self, config: CodecConfig, device):
        missing = _not_ported(config)
        if missing is not None:
            raise NotImplementedError(
                f"{missing[0]} is not ported yet (ROADMAP queue A, item "
                f"{missing[1]})")
        self.config = config
        self.device = torch.device(device)
        if self.device.type == "cuda":
            check_full_fp32()
        self.entropy_codec = entropy.get(config.entropy, config, self.device)
        #: per-stage wall times of the last encode/decode
        self.last_timings = None
        # the reference subtracts 128 before the spatial transform iff the
        # quantizer is deadzone and adds 128 to the quantization indexes
        # (src/2D-DCT.py:107-110,292,348)
        self.spatial_offset = 128 if config.quantizer == "deadzone" else 0
        self._fwd, self._inv = color_ops.get(
            config.color if config.color != "ycocg_r" else "ycocg")
        self._dwt = (dwt_ops.DWT(config.wavelet, config.dwt_levels)
                     if config.spatial == "dwt" else None)

    # ------------------------------------------------------------------
    # Device math of the block-DCT flow
    # ------------------------------------------------------------------
    def _analyze(self, padded: torch.Tensor) -> torch.Tensor:
        b = self.config.block_size
        coeff = dct_ops.analyze(self._fwd(padded - self.spatial_offset), b)
        if self.config.perceptual:
            coeff = dct_ops.perceptual_scale(coeff, b)
        if self.config.subbands:
            coeff = dct_ops.to_subbands(coeff, b)
        return coeff

    def _synthesize(self, coeff: torch.Tensor) -> torch.Tensor:
        b = self.config.block_size
        if self.config.subbands:
            coeff = dct_ops.from_subbands(coeff, b)
        if self.config.perceptual:
            coeff = dct_ops.perceptual_scale(coeff, b, inverse=True)
        return self._inv(dct_ops.synthesize(coeff, b)) + self.spatial_offset

    def _quantize(self, decom: torch.Tensor) -> torch.Tensor:
        """A decomposition, or one DWT subband, -> int32 indexes."""
        return q_ops.deadzone_quantize(decom, self.config.qss)

    def _dequantize(self, k: torch.Tensor) -> torch.Tensor:
        """Indexes of a decomposition, or of one DWT subband -> float32."""
        return q_ops.deadzone_dequantize(k, self.config.qss)

    # ------------------------------------------------------------------
    # Encode / decode entry points
    # ------------------------------------------------------------------
    def encode(self, img: np.ndarray) -> CodeStream:
        img = np.asarray(img)
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"expected (H, W, 3) image, got {img.shape}")
        self.last_timings = StageTimer(self.device)
        if self.config.spatial == "dct":
            return self._encode_spatial(img)
        if self.config.spatial == "dwt":
            return self._dwt.encode(self, img)
        return self._encode_entropy_only(img)

    def decode(self, cs: CodeStream) -> np.ndarray:
        self.last_timings = StageTimer(self.device)
        if self.config.spatial == "dct":
            return self._decode_spatial(cs)
        if self.config.spatial == "dwt":
            return self._dwt.decode(self, cs)
        return self._decode_entropy_only(cs)

    # ------------------------------------------------------------------
    # Flow: entropy only (src/PNG.py / src/TIFF.py encode/decode)
    # ------------------------------------------------------------------
    def _encode_entropy_only(self, img: np.ndarray) -> CodeStream:
        cs = CodeStream()
        payload, side = self.entropy_codec.encode(img.astype(np.uint8))
        cs[PAYLOAD] = payload
        for name, blob in side.items():
            cs[name] = blob
        return cs

    def _decode_entropy_only(self, cs: CodeStream) -> np.ndarray:
        side = {name: cs[name] for name in cs if name != PAYLOAD}
        return self.entropy_codec.decode(cs.payload, side)

    # ------------------------------------------------------------------
    # Flow: block-DCT spatial pipeline (src/2D-DCT.py encode_fn/decode_fn)
    # ------------------------------------------------------------------
    def _encode_spatial(self, img: np.ndarray) -> CodeStream:
        t = self.last_timings
        with timed_stage(t, "device:analyze+quantize"):
            x = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
            padded = dct_ops.pad_centered(x.to(torch.float32),
                                          self.config.block_size)
            k = self._quantize(self._analyze(padded))
        cs = CodeStream()
        with timed_stage(t, "entropy"):
            self._store_indexes(cs, k, offset=self.spatial_offset,
                                dtype=np.uint8)
        cs.put_shape(img.shape)
        return cs

    def _decode_spatial(self, cs: CodeStream) -> np.ndarray:
        t = self.last_timings
        shape = cs.get_shape()
        with timed_stage(t, "entropy"):
            k = self._load_indexes(cs, offset=self.spatial_offset, signed=True)
        with timed_stage(t, "device:dequantize+synthesize"):
            decom = self._dequantize(torch.from_numpy(k).to(self.device))
            y = dct_ops.unpad_centered(self._synthesize(decom), shape)
            out = torch.clamp(torch.round(y), 0, 255).to(torch.uint8)
            out = out.cpu().numpy()
        return out

    # ------------------------------------------------------------------
    # Index <-> entropy plumbing
    # ------------------------------------------------------------------
    def _store_indexes(self, cs: CodeStream, k: torch.Tensor, offset: int,
                       dtype) -> None:
        if dtype == np.uint8:
            # the reference constructs Deadzone_Quantizer(Q_step,
            # min_val=0, max_val=255) (src/deadzone.py:64): saturating
            # indexes CLAMP to the quantizer support, explicitly here, as
            # torch's out-of-range float/int -> uint8 cast is not numpy's
            stored = torch.clamp(k + offset, 0, 255).to(torch.uint8)
            stored = stored.cpu().numpy()
        else:
            # wraps like the reference's casts (src/YCoCg.py:53)
            stored = (k.cpu().numpy() + offset).astype(dtype)
        payload, side = self.entropy_codec.encode(stored)
        cs[PAYLOAD] = payload
        for name, blob in side.items():
            cs[name] = blob

    def _load_indexes(self, cs: CodeStream, offset: int,
                      signed: bool) -> np.ndarray:
        reserved = {PAYLOAD, "shape", "bopt"}
        side: Dict[str, bytes] = {
            name: cs[name]
            for name in cs
            if name not in reserved and not name.startswith("q_")
        }
        stored = self.entropy_codec.decode(cs.payload, side)
        if signed and stored.dtype == np.uint16:
            # undo the uint16 wrap of negative indexes (src/YCoCg.py:53
            # casts to uint16; int16 view restores the sign)
            k = stored.astype(np.int32)
            return np.where(k >= 32768, k - 65536, k) - offset
        return stored.astype(np.int32) - offset
