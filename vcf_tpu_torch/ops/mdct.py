"""2D MDCT, the modulated lapped transform (port of vcf_tpu/ops/mdct.py;
torch).

Malvar's MLT with a sine window meeting the Princen-Bradley condition
(src/2D-MDCT.py:87-102), MDCT and IMDCT as products with the windowed
cosine matrix, 2N -> N and N -> 2N (:105-152), 1D analysis over a
symmetric extension (:155-207), overlap-add synthesis (:210-244), rows
then columns (:247-305).  A (H, W, C) image gives (H + b, W + b, C)
coefficients; the quantizers see them scaled to the reference's range
(`coeff_scale`).

All frames of an axis are one product with the (N, 2N) matrix: framing
is a reshape of the extended signal into halves, and the overlap-add is
two slice adds.  With sqrt(2/N) scaling both ways the overlap-add
reconstructs exactly (TDAC).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from vcf_tpu_torch.codestream import CodeStream
from vcf_tpu_torch.ops import dct as dct_ops


@functools.lru_cache(maxsize=None)
def mdct_matrix(n: int) -> np.ndarray:
    """(N, 2N) windowed MDCT matrix: rows k, columns t, including the
    Princen-Bradley sine window."""
    t = np.arange(2 * n, dtype=np.float64)
    k = np.arange(n, dtype=np.float64)[:, None]
    window = np.sin(np.pi / (2 * n) * (t + 0.5))
    c = np.sqrt(2.0 / n) * np.cos(np.pi / n * (t[None, :] + 0.5 + n / 2)
                                  * (k + 0.5))
    return (c * window[None, :]).astype(np.float32)


def _matrix(n: int, device) -> torch.Tensor:
    return torch.from_numpy(mdct_matrix(n)).to(device)


def _frame_axis(x: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    """Symmetric-extend by n, then 50%-overlap frames of length 2n: input
    length L (a multiple of n) -> (L//n + 1, 2n, ...rest), frame i
    covering ext[i*n : i*n + 2n]."""
    xm = torch.movedim(x, axis, 0)
    ext = torch.cat([xm[:n].flip(0), xm, xm[-n:].flip(0)], dim=0)
    halves = ext.reshape(ext.shape[0] // n, n, *ext.shape[1:])
    return torch.cat([halves[:-1], halves[1:]], dim=1)


def mdct_axis(x: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    """MDCT along `axis`: length L -> L + n coefficients."""
    frames = _frame_axis(x, n, axis)                     # (F, 2n, ...)
    coeff = torch.einsum("kt,ft...->fk...", _matrix(n, x.device), frames)
    out = coeff.reshape(coeff.shape[0] * n, *coeff.shape[2:])
    return torch.movedim(out, 0, axis)


def imdct_axis(coeff: torch.Tensor, n: int, axis: int, l_out: int
               ) -> torch.Tensor:
    """Inverse with overlap-add; returns length `l_out` (the original L)."""
    cm = torch.movedim(coeff, axis, 0)
    f = cm.shape[0] // n
    frames = cm.reshape(f, n, *cm.shape[1:])
    y = torch.einsum("kt,fk...->ft...", _matrix(n, coeff.device), frames)
    rest = y.shape[2:]
    # frame i's first half lands at ext[i*n:(i+1)*n], its second half one
    # frame later: the sum of two shifted copies
    rec = torch.zeros(((f + 1) * n, *rest), dtype=y.dtype, device=y.device)
    rec[: f * n] += y[:, :n].reshape(f * n, *rest)
    rec[n:] += y[:, n:].reshape(f * n, *rest)
    return torch.movedim(rec[n: n + l_out], 0, axis)


def analyze(img: torch.Tensor, b: int) -> torch.Tensor:
    """Separable 2D MDCT: (H, W, C) -> (H + b, W + b, C)."""
    return mdct_axis(mdct_axis(img, b, 0), b, 1)


def synthesize(coeff: torch.Tensor, b: int, out_hw: Tuple[int, int]
               ) -> torch.Tensor:
    y = imdct_axis(coeff, b, 1, out_hw[1])
    return imdct_axis(y, b, 0, out_hw[0])


def mdct_scale_factor(b: int, quantizer: str) -> float:
    """The reference's empirical per-quantizer divisor that maps raw
    MDCT coefficients into the range the quantizers expect from the DCT
    (src/2D-MDCT.py:406-421): Lloyd-Max b/1.5; deadzone b/2 for b <= 8,
    b/4 for b >= 32, the divisor linear in between."""
    if quantizer == "lloydmax":
        return b / 1.5
    if b <= 8:
        return b / 2.0
    if b >= 32:
        return b / 4.0
    t = (b - 8) / (32 - 8)
    return (8 / 2.0) + t * ((32 / 4.0) - (8 / 2.0))


def coeff_scale(b: int, quantizer: str) -> float:
    """Multiplier of this transform's orthonormal 2D coefficients that
    gives the quantizer the reference's range: the reference's
    coefficients are (b/2)x these (it carries the 2/N in its inverse,
    src/2D-MDCT.py:105-152) and it divides them by `mdct_scale_factor`
    (:524, re-multiplied at :648)."""
    return (b / 2.0) / mdct_scale_factor(b, quantizer)


class MDCT:
    """The MDCT flow of a `Codec` (called by vcf_tpu_torch.pipeline)."""

    def __init__(self, b: int):
        self.b = b

    def encode(self, codec, img: np.ndarray) -> CodeStream:
        cfg = codec.config
        b = self.b
        soff = codec.spatial_offset

        padded = dct_ops.pad_centered(codec._upload(img).to(torch.float32), b)
        coeff = analyze(codec._fwd(padded - soff), b)          # (H+b, W+b, C)
        coeff = coeff * coeff_scale(b, cfg.quantizer)
        if cfg.subbands:
            coeff = dct_ops.to_subbands(coeff, b)

        k, qside = codec._quantize(coeff)
        cs = CodeStream()
        codec._store_indexes(cs, k, qside, offset=soff, dtype=np.uint8)
        cs.put_shape(img.shape)
        return cs

    def decode(self, codec, cs: CodeStream) -> np.ndarray:
        cfg = codec.config
        b = self.b
        soff = codec.spatial_offset

        shape = cs.get_shape()
        ph, pw = dct_ops.padded_shape(shape, b)[:2]
        k, qside = codec._load_indexes(cs, offset=soff, signed=True)
        # the coefficients' own shape, (H+b, W+b, C), not the frame's
        coeff = codec._dequantize(codec._upload(k), qside, (ph + b, pw + b, 3))
        if cfg.subbands:
            coeff = dct_ops.from_subbands(coeff, b)
        coeff = coeff / coeff_scale(b, cfg.quantizer)
        y = codec._inv(synthesize(coeff, b, (ph, pw))) + soff
        return codec._to_u8(dct_ops.unpad_centered(y, shape))
