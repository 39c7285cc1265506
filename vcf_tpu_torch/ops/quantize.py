"""Deadzone scalar quantizer (port of vcf_tpu/ops/quantize.py, deadzone
part; Lloyd-Max waits for ROADMAP A11).

Uniform mid-tread quantizer with a doubled zero bin: ``k = trunc(x /
qss)`` (truncation toward zero), ``y = k * qss``.
"""

from __future__ import annotations

import torch


def deadzone_quantize(x: torch.Tensor, qss: int) -> torch.Tensor:
    """k = trunc(x / qss), toward zero (doubled zero bin). int32 output."""
    return torch.trunc(x.to(torch.float32) / qss).to(torch.int32)


def deadzone_dequantize(k: torch.Tensor, qss: int) -> torch.Tensor:
    """y = k * qss (float32)."""
    return k.to(torch.float32) * qss
