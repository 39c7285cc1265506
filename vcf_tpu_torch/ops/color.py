"""Color transforms (port of vcf_tpu/ops/color.py; torch, channel-last).

The matrices are built from the same numpy constants as vcf_tpu's, so
both packages transform with identical float32 coefficients.  Matrix
transforms are float32 einsums over the channel axis; on CUDA they run
in full float32 (the `Codec` refuses TF32), the counterpart of
`Precision.HIGHEST`.

Variants: ``ycocg`` (Malvar's scaled YCoCg), ``ycocg_r`` (lossless
integer lifting), ``ycrcb`` (BT.601 full range), ``cdct`` (orthonormal
DCT-II over the 3 channels) and ``none``.
"""

from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Matrices (float32).  Channel-last: y = x @ M.T
# ---------------------------------------------------------------------------

YCOCG_FWD = np.array(
    [
        [0.25, 0.50, 0.25],   # Y
        [0.50, 0.00, -0.50],  # Co
        [-0.25, 0.50, -0.25], # Cg
    ],
    dtype=np.float32,
)
YCOCG_INV = np.array(
    [
        [1.0, 1.0, -1.0],  # R = Y + Co - Cg
        [1.0, 0.0, 1.0],   # G = Y + Cg
        [1.0, -1.0, -1.0], # B = Y - Co - Cg
    ],
    dtype=np.float32,
)

# BT.601 full-range YCrCb (as used by e.g. JPEG/OpenCV).  Note the channel
# order is (Y, Cr, Cb) to match cv2 / the reference's YCrCb module name.
_KR, _KG, _KB = 0.299, 0.587, 0.114
YCRCB_FWD = np.array(
    [
        [_KR, _KG, _KB],                      # Y
        [0.5, -0.5 * _KG / (1 - _KR), -0.5 * _KB / (1 - _KR)],  # Cr = (R - Y) * 0.5/(1-Kr)
        [-0.5 * _KR / (1 - _KB), -0.5 * _KG / (1 - _KB), 0.5],  # Cb = (B - Y) * 0.5/(1-Kb)
    ],
    dtype=np.float32,
)
YCRCB_INV = np.linalg.inv(YCRCB_FWD.astype(np.float64)).astype(np.float32)

# Orthonormal DCT-II over the channel axis (N=3); reference: src/color-DCT.py.
def _dct_matrix(n: int) -> np.ndarray:
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    m[0, :] /= np.sqrt(2.0)
    return m.astype(np.float32)

CDCT_FWD = _dct_matrix(3)
CDCT_INV = CDCT_FWD.T.copy()

# Chroma offsets applied after the forward transform so quantization indexes
# stay in a non-negative range (reference: src/YCoCg.py:28-31: offset
# [0,0,0] for deadzone, [-128,0,0] otherwise; src/color-DCT.py:27-30).
OFFSETS = {
    "ycocg": {"deadzone": (0, 0, 0), "other": (-128, 0, 0)},
    "ycocg_r": {"deadzone": (0, 0, 0), "other": (-128, 0, 0)},
    "ycrcb": {"deadzone": (0, -128, -128), "other": (-128, 0, 0)},
    "cdct": {"deadzone": (0, 128, 128), "other": (0, 128, 128)},
    "none": {"deadzone": (0, 0, 0), "other": (0, 0, 0)},
}


#: (forward, inverse) matrices of the linear transforms
MATRICES = {
    "ycocg": (YCOCG_FWD, YCOCG_INV),
    "ycrcb": (YCRCB_FWD, YCRCB_INV),
    "cdct": (CDCT_FWD, CDCT_INV),
}


def fma_rows(x: torch.Tensor, m: np.ndarray, axis: int = -1) -> torch.Tensor:
    """Rows of the (R, 3) float32 matrix `m` over the 3-channel `axis` of
    float32 `x` -> R channels on that axis, each the float32 fused
    multiply-add chain fma(x2, m2, fma(x1, m1, x0 * m0)), the order in
    which XLA's (and torch's) CPU dot evaluates the channel contraction.
    The chain runs in float64, rounding each step to float32: the product
    of two float32 values is exact in float64, and so is each sum when
    the operands are pixel-sized integers, so the result is the true FMA
    chain bit for bit on any device (for general floats a float64 sum may
    round before the float32 rounding, a difference with a chance of
    about 2^-29 per sample)."""
    x = x.to(torch.float64).movedim(axis, -1)
    rows = []
    for row in np.asarray(m, np.float32).astype(np.float64):
        acc = (x[..., 0] * row[0]).to(torch.float32)
        for c in (1, 2):
            acc = (x[..., c] * row[c] + acc.to(torch.float64)).to(torch.float32)
        rows.append(acc)
    return torch.stack(rows, dim=-1).movedim(-1, axis)


def _apply_matrix(x: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    return torch.einsum("...c,dc->...d", x.to(torch.float32),
                        torch.from_numpy(m).to(x.device))


# ---------------------------------------------------------------------------
# Forward / inverse pairs
# ---------------------------------------------------------------------------

def ycocg_forward(x):
    return _apply_matrix(x, YCOCG_FWD)


def ycocg_inverse(y):
    return _apply_matrix(y, YCOCG_INV)


def ycocg_r_forward(x):
    """Lossless lifting YCoCg-R (integer in, integer out)."""
    x = x.to(torch.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    co = r - b
    t = b + (co >> 1)
    cg = g - t
    y = t + (cg >> 1)
    return torch.stack([y, co, cg], dim=-1)


def ycocg_r_inverse(v):
    v = v.to(torch.int32)
    y, co, cg = v[..., 0], v[..., 1], v[..., 2]
    t = y - (cg >> 1)
    g = cg + t
    b = t - (co >> 1)
    r = b + co
    return torch.stack([r, g, b], dim=-1)


def ycrcb_forward(x):
    return _apply_matrix(x, YCRCB_FWD)


def ycrcb_inverse(y):
    return _apply_matrix(y, YCRCB_INV)


def cdct_forward(x):
    return _apply_matrix(x, CDCT_FWD)


def cdct_inverse(y):
    return _apply_matrix(y, CDCT_INV)


def identity(x):
    return x.to(torch.float32)


TRANSFORMS = {
    "ycocg": (ycocg_forward, ycocg_inverse),
    "ycocg_r": (ycocg_r_forward, ycocg_r_inverse),
    "ycrcb": (ycrcb_forward, ycrcb_inverse),
    "cdct": (cdct_forward, cdct_inverse),
    "none": (identity, identity),
}


def get(name: str):
    """Return (forward, inverse) for a color-transform name."""
    return TRANSFORMS[name]


def offsets(name: str, quantizer: str) -> np.ndarray:
    key = "deadzone" if quantizer == "deadzone" else "other"
    return np.asarray(OFFSETS[name][key], dtype=np.float32)
