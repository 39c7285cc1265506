"""Block 2D DCT, subband reordering and perceptual scaling (port of
vcf_tpu/ops/dct.py; torch).

Per-channel block-wise orthonormal 2D DCT-II as two float32 einsums with
the BxB DCT matrix (the same contraction order as vcf_tpu's), the
permutation that gathers coefficient (u, v) of every block into subband
(u, v), and the JPEG-table perceptual prescale.  On the TPU this work is
XLA outside any kernel; here it is torch's matmul, in full float32 on
CUDA (the `Codec` refuses TF32).

`analyze_xla` / `synthesize_xla` compute the same transform in the
float order of vcf_tpu's jitted DCT on the CPU, for the flows whose
result rides on a rounding tie (Lloyd-Max, VQ and no quantizer).

Layout conventions (channel-last images `(..., H, W, C)` with any
leading frame axes, H and W already multiples of the block size B):

    blocks view      : (..., H//B, B, W//B, B, C)
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
    *lead, h, w, c = img.shape
    return img.reshape(*lead, h // b, b, w // b, b, c)


def _from_blocks(blocks: torch.Tensor) -> torch.Tensor:
    *lead, nby, b, nbx, b2, c = blocks.shape
    return blocks.reshape(*lead, nby * b, nbx * b2, c)


def analyze(img: torch.Tensor, b: int) -> torch.Tensor:
    """Blockwise forward 2D DCT-II of a (..., H, W, C) image; H, W % b == 0."""
    d = torch.from_numpy(dct_matrix(b)).to(img.device)
    x = _to_blocks(img.to(torch.float32), b)
    y = torch.einsum("ur,...yrxsc->...yuxsc", d, x)
    y = torch.einsum("vs,...yuxsc->...yuxvc", d, y)
    return _from_blocks(y)


def synthesize(coeff: torch.Tensor, b: int) -> torch.Tensor:
    """Blockwise inverse 2D DCT (transpose of `analyze`)."""
    d = torch.from_numpy(dct_matrix(b)).to(coeff.device)
    y = _to_blocks(coeff.to(torch.float32), b)
    x = torch.einsum("ur,...yuxvc->...yrxvc", d, y)
    x = torch.einsum("vs,...yrxvc->...yrxsc", d, x)
    return _from_blocks(x)


def dot_rows(x: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """x (..., K) contracted with the rows of the float32 matrix m (J, K)
    -> (..., J), in the order of XLA's CPU dot when the contraction is the
    minor dimension of both operands (each pass of vcf_tpu's jitted block
    DCT): 4 lanes, lane i the fused multiply-add chain over the terms
    i, i + 4, ..., then (lane0 + lane1) + (lane2 + lane3) in float32.
    Each FMA runs in float64 (the product is exact there) and rounds once
    to float32, which is the true FMA but on a float64 sum that rounds
    onto a float32 midpoint (a chance of about 2^-29 a term, as
    `ops.color.fma_rows`); on every device the same bits."""
    m64 = torch.from_numpy(np.asarray(m, np.float32).astype(np.float64)).to(
        x.device)
    x64 = x.to(torch.float64)
    k = x.shape[-1]
    lanes = []
    for i in range(min(4, k)):
        acc = (x64[..., i, None] * m64[:, i]).to(torch.float32)
        for j in range(i + 4, k, 4):
            acc = (x64[..., j, None] * m64[:, j]
                   + acc.to(torch.float64)).to(torch.float32)
        lanes.append(acc)
    out = lanes[0] + lanes[1] if len(lanes) > 1 else lanes[0]
    if len(lanes) > 2:
        out = out + (lanes[2] + lanes[3] if len(lanes) > 3 else lanes[2])
    return out


def _xla_pass(blocks: torch.Tensor, m: np.ndarray, axis: int) -> torch.Tensor:
    """Contract the block axis `axis` (-4: rows, -2: columns) of a
    (..., y, B, x, B, c) blocks view with the rows of m, in place."""
    n = blocks.dim()
    lead = tuple(range(n - 5))
    a = n + axis
    rest = [i for i in range(n - 5, n) if i != a]
    t = dot_rows(blocks.permute(*lead, *rest, a), m)   # the axis minor
    # put the new axis back where the contracted one was
    order = list(range(n - 5, n - 1))
    order.insert(a - (n - 5), n - 1)
    return t.permute(*lead, *order)


def analyze_xla(img: torch.Tensor, b: int) -> torch.Tensor:
    """`analyze` in vcf_tpu's CPU float order: each pass a `dot_rows`."""
    d = dct_matrix(b)
    x = _to_blocks(img.to(torch.float32), b)
    return _from_blocks(_xla_pass(_xla_pass(x, d, -4), d, -2))


def synthesize_xla(coeff: torch.Tensor, b: int) -> torch.Tensor:
    """`synthesize` in vcf_tpu's CPU float order: each pass a `dot_rows`
    with the transposed DCT matrix."""
    dt = dct_matrix(b).T
    y = _to_blocks(coeff.to(torch.float32), b)
    return _from_blocks(_xla_pass(_xla_pass(y, dt, -4), dt, -2))


def to_subbands(coeff: torch.Tensor, b: int) -> torch.Tensor:
    """Gather coefficient (u, v) of all blocks into subband (u, v)."""
    *lead, h, w, c = coeff.shape
    n = len(lead)
    x = coeff.reshape(*lead, h // b, b, w // b, b, c)   # (by, u, bx, v, c)
    x = x.permute(*range(n), n + 1, n, n + 3, n + 2, n + 4)
    return x.reshape(*lead, h, w, c)


def from_subbands(sub: torch.Tensor, b: int) -> torch.Tensor:
    """Inverse of `to_subbands`."""
    *lead, h, w, c = sub.shape
    n = len(lead)
    x = sub.reshape(*lead, b, h // b, b, w // b, c)     # (u, by, v, bx, c)
    x = x.permute(*range(n), n + 1, n, n + 3, n + 2, n + 4)
    return x.reshape(*lead, h, w, c)


# ---------------------------------------------------------------------------
# Padding (reference: src/2D-DCT.py:187-229 — centered zero pad, extra to
# bottom/right).
# ---------------------------------------------------------------------------

def padded_shape(shape, b: int):
    h, w = shape[0], shape[1]
    return (-(-h // b) * b, -(-w // b) * b) + tuple(shape[2:])


def pad_centered(img: torch.Tensor, b: int, axis: int = 0) -> torch.Tensor:
    """Zero-pad the (H, W) axes `axis`, `axis + 1` of a tensor (leading
    axes: frames) to multiples of b, centered."""
    h, w = img.shape[axis], img.shape[axis + 1]
    th, tw = -(-h // b) * b, -(-w // b) * b
    ph, pw = th - h, tw - w
    # F.pad lists pads from the last dim backwards
    pads = [0, 0] * (img.dim() - 2 - axis) + [pw // 2, pw - pw // 2,
                                              ph // 2, ph - ph // 2]
    return F.pad(img, pads)


def unpad_centered(img: torch.Tensor, original_shape,
                   axis: int = 0) -> torch.Tensor:
    h, w = original_shape[0], original_shape[1]
    ph, pw = img.shape[axis] - h, img.shape[axis + 1] - w
    return img.narrow(axis, ph // 2, h).narrow(axis + 1, pw // 2, w)


# ---------------------------------------------------------------------------
# Perceptual (JPEG-table) coefficient pre-scaling (reference:
# src/2D-DCT.py:63-90 tables, :313-327 apply).  Coefficients are *scaled*
# before quantization by table/max(table) per channel class and unscaled on
# decode.  Tables are resized to BxB with area/linear interpolation.
# ---------------------------------------------------------------------------

JPEG_LUMA_QT = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    dtype=np.float32,
)
JPEG_CHROMA_QT = np.array(
    [
        [17, 18, 24, 47, 99, 99, 99, 99],
        [18, 21, 26, 66, 99, 99, 99, 99],
        [24, 26, 56, 99, 99, 99, 99, 99],
        [47, 66, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
    ],
    dtype=np.float32,
)


def _linear_coeffs(dst_n: int, src_n: int):
    """Half-pixel-center bilinear taps with 11-bit fixed-point weights
    (the standard imaging fixed-point convention; border clamp)."""
    scale = src_n / dst_n
    idx = np.empty(dst_n, np.int64)
    a0 = np.empty(dst_n, np.int64)
    for x in range(dst_n):
        fx = (x + 0.5) * scale - 0.5
        s = int(np.floor(fx))
        f = fx - s
        if s < 0:
            s, f = 0, 0.0
        if s >= src_n - 1:
            s, f = src_n - 2, 1.0
        idx[x] = s
        a0[x] = int(np.rint((1.0 - f) * 2048.0))
    return idx, a0


def resize_linear_u8(src: np.ndarray, b: int) -> np.ndarray:
    """uint8 bilinear resize to (b, b), 22-bit fixed-point accumulate
    (cv2.resize INTER_LINEAR within +-1 on half-integer cases)."""
    sh, sw = src.shape
    xs, ax = _linear_coeffs(b, sw)
    ys, ay = _linear_coeffs(b, sh)
    s = src.astype(np.int64)
    h = s[:, xs] * ax[None, :] + s[:, xs + 1] * (2048 - ax[None, :])
    out = (h[ys, :] * ay[:, None] + h[ys + 1, :] * (2048 - ay[:, None])
           + (1 << 21)) >> 22
    return np.clip(out, 0, 255).astype(np.uint8)


def _area_tab(dst_n: int, src_n: int):
    """1-D area-decimation table [(dst, src, w)] with float32 weights
    (partial-cell coverage / scale), the cv2 generic-area layout."""
    scale = src_n / dst_n
    cell = np.float32(1.0 / scale)
    tab = []
    for dx in range(dst_n):
        f1 = dx * scale
        f2 = f1 + scale
        s1, s2 = int(np.ceil(f1)), int(np.floor(f2))
        if s1 - f1 > 1e-3:
            tab.append((dx, s1 - 1, np.float32((s1 - f1) / scale)))
        for sx in range(s1, s2):
            tab.append((dx, sx, cell))
        if f2 - s2 > 1e-3:
            tab.append((dx, s2, np.float32((f2 - s2) / scale)))
    return tab


def resize_area_u8(src: np.ndarray, b: int) -> np.ndarray:
    """uint8 area-average downscale to (b, b), cv2.resize INTER_AREA
    (integer-ratio fast path: (sum + area/2) // area; generic path:
    float32 separable weights, round-half-even)."""
    sh, sw = src.shape
    ry, rx = sh / b, sw / b
    if ry == int(ry) and rx == int(rx):
        iy, ix = int(ry), int(rx)
        area = iy * ix
        s = src.astype(np.int64).reshape(b, iy, b, ix).sum((1, 3))
        return ((s + area // 2) // area).astype(np.uint8)
    hbuf = np.zeros((sh, b), np.float32)
    for dx, sx, w in _area_tab(b, sw):
        hbuf[:, dx] += src[:, sx].astype(np.float32) * w
    out = np.zeros((b, b), np.float32)
    for dy, sy, w in _area_tab(b, sh):
        out[dy, :] += hbuf[sy, :] * w
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def perceptual_tables(b: int):
    """(luma, chroma) BxB scale tables in [~0.08, 1].  The reference
    resizes the uint8 JPEG tables with cv2 (INTER_AREA if b<8 else
    INTER_LINEAR, src/2D-DCT.py:63-90) and divides by the max entry
    (121 luma / 99 chroma); the resize is reproduced by the numpy
    resamplers above."""
    if b < 8:
        luma = resize_area_u8(JPEG_LUMA_QT.astype(np.uint8), b)
        chroma = resize_area_u8(JPEG_CHROMA_QT.astype(np.uint8), b)
    else:
        luma = resize_linear_u8(JPEG_LUMA_QT.astype(np.uint8), b)
        chroma = resize_linear_u8(JPEG_CHROMA_QT.astype(np.uint8), b)
    return luma.astype(np.float32) / 121.0, chroma.astype(np.float32) / 99.0


def perceptual_scale(coeff: torch.Tensor, b: int,
                     inverse: bool = False) -> torch.Tensor:
    """Multiply (or divide) block-layout (..., H, W, 3) coefficients by
    the per-frequency perceptual tables; channel 0 uses the luma table,
    channels 1-2 chroma."""
    luma, chroma = perceptual_tables(b)
    table = torch.from_numpy(np.stack([luma, chroma, chroma], axis=-1)
                             ).to(coeff.device)            # (b, b, 3)
    x = _to_blocks(coeff, b)                               # (..., b, nbx, b, c)
    t = table[:, None, :, :]
    x = x / t if inverse else x * t
    return _from_blocks(x)
