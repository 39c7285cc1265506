"""Synthetic natural-image-like content, made on the device from a
`torch.Generator`: a frozen copy of the content model of
`vcf_tpu_torch.io.test_image` (low-frequency gradients and colour ramps,
smoothed Gaussian noise, two hard edges), with the noise drawn on the
device so that one seed gives the same frames in every run."""

from __future__ import annotations

import math

import torch


def _smooth(x: torch.Tensor, axis: int) -> torch.Tensor:
    """'same' convolution with [1, 4, 6, 4, 1] / 16 along `axis`, zero
    padded (np.convolve(mode="same"))."""
    k = (1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16)
    n = x.shape[axis]
    xp = torch.nn.functional.pad(x.movedim(axis, -1), (2, 2)).movedim(-1, axis)
    return sum(w * xp.narrow(axis, i, n) for i, w in enumerate(k))


def test_image(h: int, w: int, gen: torch.Generator, device) -> torch.Tensor:
    """(h, w, 3) uint8 on `device`."""
    f64 = torch.float64
    y = torch.arange(h, dtype=f64, device=device)[:, None] / h
    x = torch.arange(w, dtype=f64, device=device)[None, :] / w
    two_pi = 2 * math.pi
    base = torch.stack([
        128 + 80 * torch.sin(two_pi * (1.3 * x + 0.7 * y))
        + 30 * torch.cos(two_pi * 3.1 * x * y),
        128 + 70 * torch.cos(two_pi * (0.9 * x - 1.1 * y))
        + 25 * torch.sin(two_pi * 2.3 * y).expand(h, w),
        128 + 60 * torch.sin(two_pi * (2.1 * x + 1.7 * y * y)),
    ], dim=-1)
    noise = torch.randn((h, w, 3), generator=gen, device=device,
                        dtype=torch.float32).to(f64) * 18
    noise = _smooth(_smooth(noise, 0), 1)
    base = base + noise * 3.0
    base[h // 4: h // 2, w // 8: w // 3, 0] += 60
    base[int(h * 0.6):, int(w * 0.55):, 2] += 50
    return torch.clamp(base, 0, 255).to(torch.uint8)


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen
