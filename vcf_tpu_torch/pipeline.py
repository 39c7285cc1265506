"""Codec pipeline (port of vcf_tpu/pipeline.py).

A `Codec` is built from a `CodecConfig` and an explicit torch device.
Its flows mirror the reference's layer entry points:

* entropy-only          (src/PNG.py, src/TIFF.py, ... `encode()`)
* quantize-only         (src/deadzone.py `encode()`)
* color + quantize      (src/YCoCg.py `encode()`, src/no_spatial_transform.py)
* block DCT             (src/2D-DCT.py `encode_fn()`): color transform ->
  8x8 block DCT -> optional perceptual prescale -> subband order ->
  quantizer -> entropy
* DWT                   (`ops.dwt.DWT`; src/2D-DWT.py)
* palette VQ            (src/color-VQ.py)
* KLT, MDCT, LBT        (`ops.klt`, `ops.mdct.MDCT`, `ops.lbt`;
                         src/2D-KLT.py, src/2D-MDCT.py, src/2D-LBT.py)

with the quantizers deadzone, Lloyd-Max, block VQ and none.  Decode ends
with the decode-side filter (`ops.filters`: gaussian, NLM, BM3D;
src/2D-DCT.py:461), run on the Codec's device.

The pixel math runs on the device as torch ops; the entropy codec gets
the index planes and runs on the same device where it can (`rans`,
`grans`, `cgrans`) or on the host.  Trained side information (Lloyd-Max
levels, the VQ codebook, the palette) travels in the codestream as
`q_<name>` arrays.  On CUDA the codec refuses to run with TF32 matmuls:
float32 means float32, the counterpart of vcf_tpu's Precision.HIGHEST.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from vcf_tpu_torch import entropy
from vcf_tpu_torch.codestream import CodeStream, PAYLOAD
from vcf_tpu_torch.config import CodecConfig
from vcf_tpu_torch.ops import color as color_ops
from vcf_tpu_torch.ops import dct as dct_ops
from vcf_tpu_torch.ops import dwt as dwt_ops
from vcf_tpu_torch.ops import filters as filter_ops
from vcf_tpu_torch.ops import klt as klt_ops
from vcf_tpu_torch.ops import lbt as lbt_ops
from vcf_tpu_torch.ops import mdct as mdct_ops
from vcf_tpu_torch.ops import prng
from vcf_tpu_torch.ops import quantize as q_ops
from vcf_tpu_torch.ops import vq as vq_ops
from vcf_tpu_torch.utils.timing import StageTimer, timed_stage


def check_full_fp32() -> None:
    """Raise unless CUDA float32 matmuls and cuDNN convolutions run in
    full float32 (no TF32)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 must be False")
    if torch.backends.cudnn.allow_tf32:
        raise RuntimeError("torch.backends.cudnn.allow_tf32 must be False")
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError('torch.get_float32_matmul_precision() must be '
                           '"highest"')


def _to_u8(y: torch.Tensor) -> np.ndarray:
    return torch.clamp(torch.round(y), 0, 255).to(torch.uint8).cpu().numpy()


class Codec:
    """Still-image codec for one `CodecConfig` on one torch device."""

    _to_u8 = staticmethod(_to_u8)

    def __init__(self, config: CodecConfig, device):
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
        # per-channel offsets of the color-only flow (src/YCoCg.py:28-31)
        self.color_offsets = torch.from_numpy(
            color_ops.offsets(config.color, config.quantizer)).to(self.device)
        self._fwd, self._inv = color_ops.get(
            config.color if config.color != "ycocg_r" else "ycocg")
        # Lloyd-Max, VQ and no quantizer ride on rounding ties (levels
        # trained on round(coefficient), arbitrary dequantized levels):
        # their DCT takes vcf_tpu's CPU float order, which reproduces its
        # streams and goldens there and gives the card the CPU's bits.
        # Deadzone keeps the einsum, which its goldens already meet.
        if config.quantizer == "deadzone":
            self._dct, self._idct = dct_ops.analyze, dct_ops.synthesize
        else:
            self._dct, self._idct = dct_ops.analyze_xla, dct_ops.synthesize_xla
        #: the flow of the DWT, KLT, MDCT and LBT transforms, with its
        #: encode(codec, img) and decode(codec, cs); None for the others
        self._ext = {"klt": klt_ops, "lbt": lbt_ops}.get(config.spatial)
        self._dwt = None
        if config.spatial == "dwt":
            self._ext = self._dwt = dwt_ops.DWT(config.wavelet,
                                                config.dwt_levels)
        elif config.spatial == "mdct":
            self._ext = mdct_ops.MDCT(config.block_size)
        self._filter = (filter_ops.get(config, self.device)
                        if config.filter != "none" else None)

    def _upload(self, img: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(img)).to(self.device)

    # ------------------------------------------------------------------
    # Device math of the block-DCT flow
    # ------------------------------------------------------------------
    def _analyze(self, padded: torch.Tensor) -> torch.Tensor:
        b = self.config.block_size
        coeff = self._dct(self._fwd(padded - self.spatial_offset), b)
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
        return self._inv(self._idct(coeff, b)) + self.spatial_offset

    # ------------------------------------------------------------------
    # Quantizer stage over a float decomposition (shared helper)
    # ------------------------------------------------------------------
    def _quantize(self, decom: torch.Tensor
                  ) -> Tuple[torch.Tensor, Dict[str, np.ndarray]]:
        """A (H, W, C) decomposition, or one DWT subband -> (int32
        indexes, trained side info)."""
        cfg = self.config
        if cfg.quantizer == "deadzone":
            return q_ops.deadzone_quantize(decom, cfg.qss), {}
        if cfg.quantizer == "lloydmax":
            levels = q_ops.lloydmax_train(
                torch.round(decom).to(torch.int32), cfg.qss, cfg.q_min,
                cfg.q_max)
            k = q_ops.lloydmax_quantize(decom, levels)
            return k, {"levels": levels.cpu().numpy()}
        if cfg.quantizer == "vq":
            bs = cfg.vq_block_size
            padded = dct_ops.pad_centered(decom, bs)
            blocks = vq_ops.image_to_blocks(padded, bs)
            codebook, labels = vq_ops.kmeans(prng.PRNGKey(cfg.seed), blocks,
                                             cfg.vq_clusters)
            k = labels.reshape(padded.shape[0] // bs, padded.shape[1] // bs)
            return k, {"codebook": codebook.cpu().numpy()}
        if cfg.quantizer == "none":
            return torch.round(decom).to(torch.int32), {}
        raise ValueError(f"quantizer {cfg.quantizer} not usable in this flow")

    def _dequantize(self, k: torch.Tensor, qside: Dict[str, np.ndarray],
                    decom_shape) -> torch.Tensor:
        """Indexes of a decomposition of `decom_shape` (or of one DWT
        subband) -> float32."""
        cfg = self.config
        if cfg.quantizer == "deadzone":
            return q_ops.deadzone_dequantize(k, cfg.qss)
        if cfg.quantizer == "lloydmax":
            levels = torch.from_numpy(qside["levels"]).to(k.device)
            return q_ops.lloydmax_dequantize(k, levels)
        if cfg.quantizer == "vq":
            bs = cfg.vq_block_size
            codebook = torch.from_numpy(qside["codebook"]).to(k.device)
            blocks = codebook[k.reshape(-1).to(torch.int64)]
            ph, pw = dct_ops.padded_shape(decom_shape, bs)[:2]
            img = vq_ops.blocks_to_image(blocks, ph, pw, bs, decom_shape[2])
            return dct_ops.unpad_centered(img, decom_shape)
        if cfg.quantizer == "none":
            return k.to(torch.float32)
        raise ValueError(f"quantizer {cfg.quantizer} not usable in this flow")

    # ------------------------------------------------------------------
    # Encode / decode entry points
    # ------------------------------------------------------------------
    def encode(self, img: np.ndarray) -> CodeStream:
        img = np.asarray(img)
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"expected (H, W, 3) image, got {img.shape}")
        cfg = self.config
        self.last_timings = StageTimer(self.device)
        if cfg.quantizer == "colorvq":
            return self._encode_colorvq(img)
        if cfg.spatial == "dct":
            return self._encode_spatial(img)
        if self._ext is not None:
            return self._ext.encode(self, img)
        if cfg.color != "none":
            return self._encode_color(img)
        if cfg.quantizer != "none":
            return self._encode_quant(img)
        return self._encode_entropy_only(img)

    def decode(self, cs: CodeStream) -> np.ndarray:
        cfg = self.config
        self.last_timings = StageTimer(self.device)
        if cfg.quantizer == "colorvq":
            out = self._decode_colorvq(cs)
        elif cfg.spatial == "dct":
            out = self._decode_spatial(cs)
        elif self._ext is not None:
            out = self._ext.decode(self, cs)
        elif cfg.color != "none":
            out = self._decode_color(cs)
        elif cfg.quantizer != "none":
            out = self._decode_quant(cs)
        else:
            out = self._decode_entropy_only(cs)
        if self._filter is None:
            return out
        with timed_stage(self.last_timings, "device:filter"):
            return self._filter(out)

    # ------------------------------------------------------------------
    # Flow: entropy only (src/PNG.py / src/TIFF.py encode/decode)
    # ------------------------------------------------------------------
    def _encode_entropy_only(self, img: np.ndarray) -> CodeStream:
        cs = CodeStream()
        with timed_stage(self.last_timings, "entropy"):
            payload, side = self.entropy_codec.encode(img.astype(np.uint8))
        cs[PAYLOAD] = payload
        for name, blob in side.items():
            cs[name] = blob
        return cs

    def _decode_entropy_only(self, cs: CodeStream) -> np.ndarray:
        side = {name: cs[name] for name in cs if name != PAYLOAD}
        with timed_stage(self.last_timings, "entropy"):
            return self.entropy_codec.decode(cs.payload, side)

    # ------------------------------------------------------------------
    # Flow: quantize only (src/deadzone.py encode/decode: uint8 indexes,
    # y = k*qss out)
    # ------------------------------------------------------------------
    def _encode_quant(self, img: np.ndarray) -> CodeStream:
        t = self.last_timings
        with timed_stage(t, "device:analyze+quantize"):
            k, qside = self._quantize(self._upload(img).to(torch.float32))
        cs = CodeStream()
        with timed_stage(t, "entropy"):
            self._store_indexes(cs, k, qside, offset=0, dtype=np.uint8)
        cs.put_shape(img.shape)
        return cs

    def _decode_quant(self, cs: CodeStream) -> np.ndarray:
        t = self.last_timings
        shape = cs.get_shape()
        with timed_stage(t, "entropy"):
            k, qside = self._load_indexes(cs, offset=0, signed=False)
        with timed_stage(t, "device:dequantize+synthesize"):
            return _to_u8(self._dequantize(self._upload(k), qside, shape))

    # ------------------------------------------------------------------
    # Flow: color transform + quantize (src/YCoCg.py encode/decode)
    # ------------------------------------------------------------------
    def _encode_color(self, img: np.ndarray) -> CodeStream:
        cfg = self.config
        t = self.last_timings
        fwd, _ = color_ops.get(cfg.color)
        with timed_stage(t, "device:analyze+quantize"):
            x = self._upload(img)
            # ycocg_r lifts integers; every other transform takes float32
            ct = fwd(x if cfg.color == "ycocg_r" else x.to(torch.float32))
            k, qside = self._quantize(
                (ct + self.color_offsets).to(torch.float32))
        cs = CodeStream()
        with timed_stage(t, "entropy"):
            # the reference casts these indexes to uint16 (src/YCoCg.py:53);
            # negative chroma indexes wrap and unwrap on decode (ROADMAP C4)
            self._store_indexes(cs, k, qside, offset=0, dtype=np.uint16)
        cs.put_shape(img.shape)
        return cs

    def _decode_color(self, cs: CodeStream) -> np.ndarray:
        t = self.last_timings
        _, inv = color_ops.get(self.config.color)
        shape = cs.get_shape()
        with timed_stage(t, "entropy"):
            k, qside = self._load_indexes(cs, offset=0, signed=True)
        with timed_stage(t, "device:dequantize+synthesize"):
            ct = self._dequantize(self._upload(k), qside, shape)
            return _to_u8(inv(ct - self.color_offsets))

    # ------------------------------------------------------------------
    # Flow: block-DCT spatial pipeline (src/2D-DCT.py encode_fn/decode_fn)
    # ------------------------------------------------------------------
    def _encode_spatial(self, img: np.ndarray) -> CodeStream:
        t = self.last_timings
        with timed_stage(t, "device:analyze+quantize"):
            padded = dct_ops.pad_centered(self._upload(img).to(torch.float32),
                                          self.config.block_size)
            k, qside = self._quantize(self._analyze(padded))
        cs = CodeStream()
        with timed_stage(t, "entropy"):
            self._store_indexes(cs, k, qside, offset=self.spatial_offset,
                                dtype=np.uint8)
        cs.put_shape(img.shape)
        return cs

    def _decode_spatial(self, cs: CodeStream) -> np.ndarray:
        t = self.last_timings
        shape = cs.get_shape()
        padded_shape = dct_ops.padded_shape(shape, self.config.block_size)
        with timed_stage(t, "entropy"):
            k, qside = self._load_indexes(cs, offset=self.spatial_offset,
                                          signed=True)
        with timed_stage(t, "device:dequantize+synthesize"):
            decom = self._dequantize(self._upload(k), qside, padded_shape)
            y = dct_ops.unpad_centered(self._synthesize(decom), shape)
            return _to_u8(y)

    # ------------------------------------------------------------------
    # Flow: palette VQ (src/color-VQ.py: color transform + quantizer in one)
    # ------------------------------------------------------------------
    def _encode_colorvq(self, img: np.ndarray) -> CodeStream:
        cfg = self.config
        t = self.last_timings
        h, w, _ = img.shape
        with timed_stage(t, "device:analyze+quantize"):
            pixels = self._upload(img).to(torch.float32).reshape(-1, 3)
            palette, labels = vq_ops.kmeans(prng.PRNGKey(cfg.seed), pixels,
                                            cfg.colorvq_clusters)
            dtype = np.uint8 if cfg.colorvq_clusters <= 256 else np.uint16
            k = labels.reshape(h, w).cpu().numpy().astype(dtype)
        cs = CodeStream()
        with timed_stage(t, "entropy"):
            payload, side = self.entropy_codec.encode(k)
        cs[PAYLOAD] = payload
        for name, blob in side.items():
            cs[name] = blob
        cs.put_array("centroids", palette.cpu().numpy())
        cs.put_shape(img.shape)
        return cs

    def _decode_colorvq(self, cs: CodeStream) -> np.ndarray:
        t = self.last_timings
        side = {name: cs[name] for name in cs
                if name not in (PAYLOAD, "centroids", "shape")}
        with timed_stage(t, "entropy"):
            k = self.entropy_codec.decode(cs.payload, side)
        with timed_stage(t, "device:dequantize+synthesize"):
            palette = torch.from_numpy(cs.get_array("centroids")).to(
                self.device)
            out = palette[self._upload(k.astype(np.int64)).reshape(-1)]
            return _to_u8(out.reshape(k.shape + (3,)))

    # ------------------------------------------------------------------
    # Index <-> entropy plumbing
    # ------------------------------------------------------------------
    def _store_indexes(self, cs: CodeStream, k: torch.Tensor,
                       qside: Dict[str, np.ndarray], offset: int,
                       dtype) -> None:
        cfg = self.config
        if cfg.quantizer == "vq":
            # the label map (src/VQ.py labels uint16)
            stored = k.cpu().numpy().astype(np.uint16)
        elif cfg.quantizer == "deadzone" and dtype == np.uint8:
            # the reference constructs Deadzone_Quantizer(Q_step,
            # min_val=0, max_val=255) (src/deadzone.py:64): saturating
            # indexes CLAMP to the quantizer support, explicitly here, as
            # torch's out-of-range float/int -> uint8 cast is not numpy's
            stored = torch.clamp(k + offset, 0, 255).to(torch.uint8)
            stored = stored.cpu().numpy()
        else:
            # wraps like the reference's casts (src/YCoCg.py:53, ROADMAP C4)
            stored = (k.cpu().numpy() + offset).astype(dtype)
        payload, side = self.entropy_codec.encode(stored)
        cs[PAYLOAD] = payload
        for name, blob in side.items():
            cs[name] = blob
        for name, arr in qside.items():
            cs.put_array(f"q_{name}", arr)

    def _load_indexes(self, cs: CodeStream, offset: int, signed: bool):
        """-> (int32 indexes, trained side info)."""
        reserved = {PAYLOAD, "shape", "bopt"}
        side: Dict[str, bytes] = {
            name: cs[name]
            for name in cs
            if name not in reserved and not name.startswith("q_")
        }
        stored = self.entropy_codec.decode(cs.payload, side)
        qside = {name[2:]: cs.get_array(name)
                 for name in cs if name.startswith("q_")}
        if self.config.quantizer == "vq":
            return stored.astype(np.int32), qside
        k = stored.astype(np.int32)
        if signed and stored.dtype == np.uint16:
            # undo the uint16 wrap of negative indexes (src/YCoCg.py:53
            # casts to uint16; int16 view restores the sign)
            k = np.where(k >= 32768, k - 65536, k)
        return k - offset, qside
