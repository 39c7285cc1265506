"""Block 2D DCT and subband reordering (port of vcf_tpu/ops/dct.py; torch).

Per-channel block-wise orthonormal 2D DCT-II as two float32 einsums with
the BxB DCT matrix (the same contraction order as vcf_tpu's), and the
permutation that gathers coefficient (u, v) of every block into subband
(u, v).  On the TPU this work is XLA outside any kernel; here it is
torch's matmul, in full float32 on CUDA (the `Codec` refuses TF32).
Perceptual (JPEG-table) prescaling is not ported yet (ROADMAP A17).

Layout conventions (channel-last images `(H, W, C)`, H and W already
multiples of the block size B):

    blocks view      : (H//B, B, W//B, B, C)
    subband layout   : out[u*(H//B)+by, v*(W//B)+bx, c]
                         = coeff[by*B+u, bx*B+v, c]
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix D: y = D @ x transforms one length-n signal."""
    k = np.arange(n)[:, None].astype(np.float64)
    i = np.arange(n)[None, :].astype(np.float64)
    m = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    m[0, :] /= np.sqrt(2.0)
    return m.astype(np.float32)


def _to_blocks(img: torch.Tensor, b: int) -> torch.Tensor:
    h, w, c = img.shape
    return img.reshape(h // b, b, w // b, b, c)


def _from_blocks(blocks: torch.Tensor) -> torch.Tensor:
    nby, b, nbx, b2, c = blocks.shape
    return blocks.reshape(nby * b, nbx * b2, c)


def analyze(img: torch.Tensor, b: int) -> torch.Tensor:
    """Blockwise forward 2D DCT-II of a (H, W, C) image; H, W % b == 0."""
    d = torch.from_numpy(dct_matrix(b)).to(img.device)
    x = _to_blocks(img.to(torch.float32), b)
    y = torch.einsum("ur,yrxsc->yuxsc", d, x)
    y = torch.einsum("vs,yuxsc->yuxvc", d, y)
    return _from_blocks(y)


def synthesize(coeff: torch.Tensor, b: int) -> torch.Tensor:
    """Blockwise inverse 2D DCT (transpose of `analyze`)."""
    d = torch.from_numpy(dct_matrix(b)).to(coeff.device)
    y = _to_blocks(coeff.to(torch.float32), b)
    x = torch.einsum("ur,yuxvc->yrxvc", d, y)
    x = torch.einsum("vs,yrxvc->yrxsc", d, x)
    return _from_blocks(x)


def to_subbands(coeff: torch.Tensor, b: int) -> torch.Tensor:
    """Gather coefficient (u, v) of all blocks into subband (u, v)."""
    h, w, c = coeff.shape
    x = coeff.reshape(h // b, b, w // b, b, c)          # (by, u, bx, v, c)
    x = x.permute(1, 0, 3, 2, 4)                         # (u, by, v, bx, c)
    return x.reshape(h, w, c)


def from_subbands(sub: torch.Tensor, b: int) -> torch.Tensor:
    """Inverse of `to_subbands`."""
    h, w, c = sub.shape
    x = sub.reshape(b, h // b, b, w // b, c)             # (u, by, v, bx, c)
    x = x.permute(1, 0, 3, 2, 4)                         # (by, u, bx, v, c)
    return x.reshape(h, w, c)


# ---------------------------------------------------------------------------
# Padding (reference: src/2D-DCT.py:187-229 — centered zero pad, extra to
# bottom/right).
# ---------------------------------------------------------------------------

def padded_shape(shape, b: int):
    h, w = shape[0], shape[1]
    return (-(-h // b) * b, -(-w // b) * b) + tuple(shape[2:])


def pad_centered(img: torch.Tensor, b: int) -> torch.Tensor:
    """Zero-pad a (H, W, ...) tensor to multiples of b, centered."""
    h, w = img.shape[0], img.shape[1]
    th, tw = -(-h // b) * b, -(-w // b) * b
    ph, pw = th - h, tw - w
    # F.pad lists pads from the last dim backwards
    pads = [0, 0] * (img.dim() - 2) + [pw // 2, pw - pw // 2,
                                       ph // 2, ph - ph // 2]
    return F.pad(img, pads)


def unpad_centered(img: torch.Tensor, original_shape) -> torch.Tensor:
    h, w = original_shape[0], original_shape[1]
    ph, pw = img.shape[0] - h, img.shape[1] - w
    top, left = ph // 2, pw // 2
    return img[top : top + h, left : left + w]
