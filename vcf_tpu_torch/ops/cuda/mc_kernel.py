"""Block motion-compensation kernel (port of vcf_tpu/ops/pallas/mc_kernel.py).

`mc_apply_planar` replaces the Pallas function of the same name (:115):
(3, H, W) or (G, 3, H, W) float32 frames and (nby, nbx, 2) or
(G, nby, nbx, 2) int32 mvs -> the motion-compensated frames,
out[c, y, x] = ref[c, clamp(y + mv_y), clamp(x + mv_x)] with the vector of
the block holding (y, x).  `mc_apply` (:103) is the channel-last layout,
(H, W, 3) or (G, H, W, 3), a mode of the same kernel rather than a
transpose around it.  Any channel count is taken.

The TPU swept every displacement with a mask-accumulate (XLA gathers were
slow there); the CUDA kernel (csrc/motion.cu) is a gather.  Its vector
mode, for m % 4 == 0 and 16-byte aligned frames (`launch_mode`), gives a
thread a run of 4 outputs of one block row, its mv read once, and walks
the block's rows with 16-byte stores; every other shape takes the generic
mode, one thread per output element, counted in `fn.generic_launches`.
A copy, so it equals the plain versions bit for bit; they equal
`ops.motion.compensate` for |mv| <= its pad.  `supports` and `_pick_tile`
(VMEM tiling) have no counterpart.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel.
Each wrapper counts its launches in `fn.launches`; `mc_apply_planar`
runs in a `vcf.motion.compensate` span (`utils.profiling`).
"""

from __future__ import annotations

import torch

from vcf_tpu_torch.ops import motion
from vcf_tpu_torch.ops.cuda import _build
from vcf_tpu_torch.utils import profiling


def mc_apply_ref(ref: torch.Tensor, mv: torch.Tensor, m: int) -> torch.Tensor:
    """Plain version of `mc_apply` (channel-last)."""
    return motion.compensate(ref, mv, m, pad=None)


def mc_apply_planar_ref(ref: torch.Tensor, mv: torch.Tensor,
                        m: int) -> torch.Tensor:
    """Plain version of `mc_apply_planar`."""
    return motion.compensate(ref.movedim(-3, -1), mv, m,
                             pad=None).movedim(-1, -3)


#: outputs a thread of the vector mode writes (MC_VEC in csrc/motion.cu)
VEC = 4


def launch_mode(m: int, ref_ptr: int, out_ptr: int) -> str:
    """The mode the kernel takes in either layout (`vcf_mc_mode`'s choice,
    by block size and alignment): "vector" for m % 4 == 0 (a row, W or
    W * C floats, is then a multiple of 4) and 16-byte aligned frames,
    else "generic"."""
    if m % VEC == 0 and ref_ptr % 16 == 0 and out_ptr % 16 == 0:
        return "vector"
    return "generic"


def _launch(fn, ref: torch.Tensor, mv: torch.Tensor, m: int,
            channel_last: bool) -> torch.Tensor:
    """Launch the kernel for the wrapper `fn` and count it there."""
    if ref.dim() not in (3, 4):
        raise ValueError(f"motion compensation: expected 3-D or 4-D float32 "
                         f"frames, got {ref.dtype} {tuple(ref.shape)}")
    lead = ref.shape[:-3]
    if channel_last:
        h, w, c = ref.shape[-3:]
    else:
        c, h, w = ref.shape[-3:]
    if (ref.dtype != torch.float32 or mv.dtype != torch.int32 or h % m
            or w % m or mv.shape != (*lead, h // m, w // m, 2)
            or mv.device != ref.device):
        raise ValueError(f"motion compensation: {ref.dtype} "
                         f"{tuple(ref.shape)} frames with block {m} take "
                         f"int32 mvs of shape {(*lead, h // m, w // m, 2)}, "
                         f"got {mv.dtype} {tuple(mv.shape)} on {mv.device}")
    if not ref.is_contiguous():
        ref = ref.contiguous()
    if not mv.is_contiguous():
        mv = mv.contiguous()
    out = torch.empty_like(ref)
    dev = ref.device
    args = (ref.data_ptr(), mv.data_ptr(), out.data_ptr(),
            ref.shape[0] if lead else 1, c, h, w, m, int(channel_last),
            _build.stream_of(ref))
    lib = _build.load()
    if dev.index == torch.cuda.current_device():
        rc = lib.vcf_mc_apply(*args)
    else:
        with torch.cuda.device(dev):
            rc = lib.vcf_mc_apply(*args)
    _build.check(rc, "vcf_mc_apply")
    fn.launches += 1
    if launch_mode(m, args[0], args[2]) == "generic":
        fn.generic_launches += 1
    return out


def mc_apply_planar(ref: torch.Tensor, mv: torch.Tensor, m: int) -> torch.Tensor:
    """(..., C, H, W) float32 frames -> motion-compensated frames."""
    with profiling.span("vcf.motion.compensate"):
        if _build.runs_plain(ref):
            return mc_apply_planar_ref(ref, mv, m)
        return _launch(mc_apply_planar, ref, mv, m, channel_last=False)


def mc_apply(ref: torch.Tensor, mv: torch.Tensor, m: int) -> torch.Tensor:
    """(..., H, W, C) float32 frames -> motion-compensated frames."""
    if _build.runs_plain(ref):
        return mc_apply_ref(ref, mv, m)
    return _launch(mc_apply, ref, mv, m, channel_last=True)


for _fn in (mc_apply_planar, mc_apply):
    _fn.launches = 0
    _fn.generic_launches = 0
