"""Deadzone scalar quantizer (port of vcf_tpu/ops/quantize.py, deadzone
part; Lloyd-Max waits for ROADMAP A11).

Uniform mid-tread quantizer with a doubled zero bin: ``k = trunc(x /
qss)`` (truncation toward zero), ``y = k * qss``.
"""

from __future__ import annotations

import torch


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
