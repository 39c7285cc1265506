"""Plain reference of VCF's default still transform and quantizer.

Pixels (..., 3, H, W) uint8 -> YCoCg -> 8x8 orthonormal DCT-II per
block -> deadzone quantizer trunc(c / qss) + 128, saturated to 0..255
-> uint8 indexes in block layout; and the inverse, rounded half to even
and clipped to 0..255.  Float32 throughout, as the configuration states,
with each DCT pass a float32 matrix product.

`tf32=True` is the control: every operand of the two DCT matrix products
is rounded to TF32 (10 explicit mantissa bits, round to nearest even)
before a float32 product, which is what a tensor core does with float32
inputs when TF32 is allowed.  The emulation is explicit, so the control
reads the same on the CPU and on the card.

Plain torch only: no kernel, no import of the code under test.
"""

from __future__ import annotations

import math

import torch

OFFSET = 128

# VCF's YCoCg (src/YCoCg.py), rows applied to (R, G, B)
YCOCG_FWD = ((0.25, 0.50, 0.25), (0.50, 0.00, -0.50), (-0.25, 0.50, -0.25))
YCOCG_INV = ((1.0, 1.0, -1.0), (1.0, 0.0, 1.0), (1.0, -1.0, -1.0))


def dct_matrix(b: int, device) -> torch.Tensor:
    """Orthonormal DCT-II matrix D (b x b) as float32: y = D @ x."""
    rows = []
    for k in range(b):
        scale = math.sqrt(1.0 / b) if k == 0 else math.sqrt(2.0 / b)
        rows.append([scale * math.cos(math.pi * (2 * i + 1) * k / (2 * b))
                     for i in range(b)])
    return torch.tensor(rows, dtype=torch.float64, device=device).to(
        torch.float32)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties to even), as float32."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0xFFF + lsb) & -8192).view(torch.float32)


def _color(x: torch.Tensor, m) -> torch.Tensor:
    """3x3 matrix rows over the channel axis (-3) of float32 x."""
    c = [x[..., i, :, :] for i in range(3)]
    return torch.stack([m[d][0] * c[0] + m[d][1] * c[1] + m[d][2] * c[2]
                        for d in range(3)], dim=-3)


def _blocks(x: torch.Tensor, b: int) -> torch.Tensor:
    """(..., H, W) -> (..., H/b, W/b, b, b)."""
    *lead, h, w = x.shape
    return x.reshape(*lead, h // b, b, w // b, b).transpose(-3, -2)


def _unblocks(x: torch.Tensor) -> torch.Tensor:
    *lead, nh, nw, b, _ = x.shape
    return x.transpose(-3, -2).reshape(*lead, nh * b, nw * b)


def _mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32:
        a, b = round_tf32(a), round_tf32(b)
    return torch.matmul(a, b)


def dct2(x: torch.Tensor, b: int = 8, tf32: bool = False) -> torch.Tensor:
    """Blockwise D @ X @ D^T of (..., H, W) float32."""
    d = dct_matrix(b, x.device)
    y = _mm(d, _blocks(x, b), tf32)
    return _unblocks(_mm(y, d.t().contiguous(), tf32))


def idct2(c: torch.Tensor, b: int = 8, tf32: bool = False) -> torch.Tensor:
    """Blockwise D^T @ C @ D of (..., H, W) float32."""
    d = dct_matrix(b, c.device)
    y = _mm(d.t().contiguous(), _blocks(c, b), tf32)
    return _unblocks(_mm(y, d, tf32))


def forward(pixels: torch.Tensor, qss: int = 32, b: int = 8,
            tf32: bool = False) -> torch.Tensor:
    """(..., 3, H, W) uint8 pixels -> (..., 3, H, W) uint8 indexes."""
    ct = _color(pixels.to(torch.float32) - OFFSET, YCOCG_FWD)
    k = torch.trunc(dct2(ct, b, tf32) / qss).to(torch.int32) + OFFSET
    return torch.clamp(k, 0, 255).to(torch.uint8)


def inverse(k: torch.Tensor, qss: int = 32, b: int = 8,
            tf32: bool = False) -> torch.Tensor:
    """(..., 3, H, W) uint8 indexes -> (..., 3, H, W) uint8 pixels."""
    coeff = (k.to(torch.int32) - OFFSET).to(torch.float32) * qss
    pix = _color(idct2(coeff, b, tf32), YCOCG_INV) + OFFSET
    return torch.clamp(torch.round(pix), 0, 255).to(torch.uint8)
