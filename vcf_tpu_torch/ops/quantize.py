"""Scalar quantizers: deadzone and Lloyd-Max (port of
vcf_tpu/ops/quantize.py).

* Deadzone: uniform mid-tread quantizer with a doubled zero bin,
  ``k = trunc(x / qss)`` (truncation toward zero), ``y = k * qss``.
* Lloyd-Max: per-channel optimal scalar quantizer seeded from the
  image's own histogram (Laplace-smoothed, src/LloydMax.py:96-101) and
  refined by a fixed number of Lloyd iterations; the decision
  boundaries are midpoints between representation levels and each level
  is the centroid of its bin.  The levels are codestream side
  information (src/LloydMax.py:107-112).

Lloyd-Max sums exactly.  Each step's bin mass and first moment are sums
of integers (count + 1, times an integer support value); vcf_tpu takes
them as float32 einsums, exact while every partial sum stays below 2^24,
which holds at small sizes.  Here they are taken in float64 (exact to
2^53, in any order), rounded to float32, and divided in float32 as
vcf_tpu divides: the same levels wherever vcf_tpu's sums are exact, and
the same levels on every device past that, where vcf_tpu's own result
depends on XLA's summation order (ROADMAP C11).
"""

from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Deadzone
# ---------------------------------------------------------------------------

def deadzone_quantize(x: torch.Tensor, qss: int) -> torch.Tensor:
    """k = trunc(x / qss), toward zero (doubled zero bin). int32 output.
    The divisor is a tensor on x's device: PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal, which is not the IEEE
    quotient when qss is not a power of two (ROADMAP C9)."""
    q = torch.tensor(qss, dtype=torch.float32, device=x.device)
    return torch.trunc(x.to(torch.float32) / q).to(torch.int32)


def deadzone_dequantize(k: torch.Tensor, qss: int) -> torch.Tensor:
    """y = k * qss (float32)."""
    return k.to(torch.float32) * qss


# ---------------------------------------------------------------------------
# Lloyd-Max
# ---------------------------------------------------------------------------

LLOYD_ITERS = 30


def lloydmax_levels(qss: int, q_min: int, q_max: int) -> int:
    """Number of representation levels for a nominal step size: the
    reference builds `(max - min + 1) / qss` levels over the support
    (src/LloydMax.py:96-101)."""
    n = (q_max - q_min + 1) // int(qss)
    return max(2, min(n, 256 * 256))


def lloydmax_histogram(x: torch.Tensor, q_min: int,
                       q_max: int) -> torch.Tensor:
    """Per-channel raw counts over the integer support [q_min, q_max].

    x: (..., C) int-valued tensor; values outside the support count in
    its end bins, as vcf_tpu's clipped histogram counts them.  Returns
    (C, V) int64 counts, V the support size: the training statistic that
    sums across frames for a shared level set."""
    n_vals = q_max - q_min + 1
    c = x.shape[-1]
    flat = x.reshape(-1, c).to(torch.int64)
    bins = torch.clamp(flat - q_min, 0, n_vals - 1)
    bins = bins + torch.arange(c, device=x.device) * n_vals
    return torch.bincount(bins.reshape(-1), minlength=c * n_vals).reshape(
        c, n_vals)


def _init_levels(n_levels: int, q_min: int, q_max: int) -> np.ndarray:
    """Uniform spacing over the support, in vcf_tpu's float32 ops:
    q_min + (arange + 0.5) * float32((q_max - q_min + 1) / n_levels)."""
    f32 = np.float32
    step = f32((q_max - q_min + 1) / n_levels)
    return f32(q_min) + (np.arange(n_levels, dtype=f32) + f32(0.5)) * step


def lloydmax_train_from_hist(hist: torch.Tensor, qss: int, q_min: int,
                             q_max: int,
                             iters: int = LLOYD_ITERS) -> torch.Tensor:
    """Lloyd iterations from a (C, V) raw-count histogram -> (C, L)
    float32 levels on the histogram's device.

    +1 Laplace smoothing is applied here (src/LloydMax.py:96-101), so
    callers pass raw counts, which makes the statistic additive across
    frames (sum then train == train on the union)."""
    dev = hist.device
    n_levels = lloydmax_levels(qss, q_min, q_max)
    c, n_vals = hist.shape
    support = torch.arange(q_min, q_max + 1, dtype=torch.float32,
                           device=dev)
    w = hist.to(torch.float64) + 1.0
    wv = w * support.to(torch.float64)              # exact: |.| < 2^53
    levels = torch.from_numpy(_init_levels(n_levels, q_min, q_max)).to(
        dev).expand(c, n_levels).contiguous()
    rows = (torch.arange(c, device=dev) * n_levels)[:, None]
    values = support.expand(c, n_vals).contiguous()
    for _ in range(iters):
        bounds = 0.5 * (levels[:, 1:] + levels[:, :-1])          # (C, L-1)
        # the bin of every support value: the count of bounds <= v
        assign = torch.searchsorted(bounds, values, right=True)
        idx = (assign + rows).reshape(-1)
        mass = torch.zeros(c * n_levels, dtype=torch.float64, device=dev)
        moment = torch.zeros_like(mass)
        mass.index_add_(0, idx, w.reshape(-1))
        moment.index_add_(0, idx, wv.reshape(-1))
        mass = mass.to(torch.float32).reshape(c, n_levels)
        moment = moment.to(torch.float32).reshape(c, n_levels)
        new = moment / torch.clamp(mass, min=1e-30)
        levels = torch.where(mass > 0, new, levels)
    return levels


def lloydmax_train(x: torch.Tensor, qss: int, q_min: int, q_max: int,
                   iters: int = LLOYD_ITERS) -> torch.Tensor:
    """Per-channel Lloyd-Max levels of the int-valued (..., C) tensor x:
    (C, L) float32, ascending."""
    hist = lloydmax_histogram(x, q_min, q_max)
    return lloydmax_train_from_hist(hist, qss, q_min, q_max, iters)


def lloydmax_quantize(x: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """(..., C) values -> int32 nearest-level indexes in [0, L-1] by the
    midpoint bounds (the right side of a bound, as vcf_tpu's
    searchsorted)."""
    bounds = 0.5 * (levels[:, 1:] + levels[:, :-1])              # (C, L-1)
    c = x.shape[-1]
    flat = x.reshape(-1, c).to(torch.float32).t().contiguous()   # (C, N)
    k = torch.searchsorted(bounds.contiguous(), flat, right=True)
    return k.t().reshape(x.shape).to(torch.int32)


def lloydmax_dequantize(k: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """y[..., c] = levels[c, k[..., c]] (indexes clipped to the levels)."""
    c, n_levels = levels.shape
    idx = torch.clamp(k.reshape(-1, c).to(torch.int64), 0, n_levels - 1)
    y = levels.gather(1, idx.t().contiguous())                  # (C, N)
    return y.t().reshape(k.shape).to(torch.float32)
