"""Block motion-compensation kernel (port of vcf_tpu/ops/pallas/mc_kernel.py).

`mc_apply_planar` replaces the Pallas function of the same name (:115):
(3, H, W) or (G, 3, H, W) float32 frames and (nby, nbx, 2) or
(G, nby, nbx, 2) int32 mvs -> the motion-compensated frames,
out[c, y, x] = ref[c, clamp(y + mv_y), clamp(x + mv_x)] with the vector of
the block holding (y, x).  `mc_apply` (:103) is the channel-last layout,
(H, W, 3) or (G, H, W, 3), a mode of the same kernel rather than a
transpose around it.  Any channel count is taken.

The TPU swept every displacement with a mask-accumulate (XLA gathers were
slow there); the CUDA kernel (csrc/motion.cu) is a gather, one thread per
output element.  A copy, so it equals the plain versions bit for bit; they
equal `ops.motion.compensate` for |mv| <= its pad.  `supports` and
`_pick_tile` (VMEM tiling) have no counterpart.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel.
Each wrapper counts its launches in `fn.launches`.
"""

from __future__ import annotations

import torch

from vcf_tpu_torch.ops import motion
from vcf_tpu_torch.ops.cuda import _build


def mc_apply_ref(ref: torch.Tensor, mv: torch.Tensor, m: int) -> torch.Tensor:
    """Plain version of `mc_apply` (channel-last)."""
    return motion.compensate(ref, mv, m, pad=None)


def mc_apply_planar_ref(ref: torch.Tensor, mv: torch.Tensor,
                        m: int) -> torch.Tensor:
    """Plain version of `mc_apply_planar`."""
    return motion.compensate(ref.movedim(-3, -1), mv, m,
                             pad=None).movedim(-1, -3)


def _launch(ref: torch.Tensor, mv: torch.Tensor, m: int,
            channel_last: bool) -> torch.Tensor:
    if ref.dtype != torch.float32 or ref.dim() not in (3, 4):
        raise ValueError(f"motion compensation: expected 3-D or 4-D float32 "
                         f"frames, got {ref.dtype} {tuple(ref.shape)}")
    lead = ref.shape[:-3]
    if channel_last:
        h, w, c = ref.shape[-3:]
    else:
        c, h, w = ref.shape[-3:]
    if (mv.dtype != torch.int32 or tuple(mv.shape) != (*lead, h // m, w // m, 2)
            or h % m or w % m or mv.device != ref.device):
        raise ValueError(f"motion compensation: {tuple(ref.shape)} frames "
                         f"with block {m} take int32 mvs of shape "
                         f"{(*lead, h // m, w // m, 2)}, got {mv.dtype} "
                         f"{tuple(mv.shape)} on {mv.device}")
    ref = ref.contiguous()
    mv = mv.contiguous()
    out = torch.empty_like(ref)
    g = ref.shape[0] if lead else 1
    lib = _build.load()
    with torch.cuda.device(ref.device):
        rc = lib.vcf_mc_apply(ref.data_ptr(), mv.data_ptr(), out.data_ptr(),
                              g, c, h, w, m, int(channel_last),
                              _build.stream_of(ref))
    _build.check(rc, "vcf_mc_apply")
    return out


def mc_apply_planar(ref: torch.Tensor, mv: torch.Tensor, m: int) -> torch.Tensor:
    """(..., C, H, W) float32 frames -> motion-compensated frames."""
    if _build.runs_plain(ref):
        return mc_apply_planar_ref(ref, mv, m)
    out = _launch(ref, mv, m, channel_last=False)
    mc_apply_planar.launches += 1
    return out


def mc_apply(ref: torch.Tensor, mv: torch.Tensor, m: int) -> torch.Tensor:
    """(..., H, W, C) float32 frames -> motion-compensated frames."""
    if _build.runs_plain(ref):
        return mc_apply_ref(ref, mv, m)
    out = _launch(ref, mv, m, channel_last=True)
    mc_apply.launches += 1
    return out


for _fn in (mc_apply_planar, mc_apply):
    _fn.launches = 0
