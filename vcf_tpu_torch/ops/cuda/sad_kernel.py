"""Full-search block SAD motion estimation kernel (port of
vcf_tpu/ops/pallas/sad_kernel.py).

`sad_search` replaces both Pallas functions, `sad_search` (:58) and the
row-tiled `sad_search_tiled` (:141): (H, W) or (G, H, W) float32 lumas ->
(mv (..., nby, nbx, 2) int32 (dy, dx) of the first minimum in row-major
order, sad (..., nby, nbx) float32).  The TPU's tiles, `tile_h` and VMEM
gates have no counterpart: one CTA stages each block's window in shared
memory (csrc/motion.cu), and the argmin is fused into the kernel.

A CPU tensor runs the plain version, `sad_search_ref` (which is
`ops.motion.full_search`); a CUDA tensor launches the kernel.  Both sum
in float64, where a block's SAD is exact in any order, so they agree bit
for bit: mvs and SADs.  `sad_search.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from vcf_tpu_torch.ops import motion
from vcf_tpu_torch.ops.cuda import _build

#: shared memory the kernel stages per CTA: the (m + 2s)^2 window and the
#: m x m block, in float64, within the 48 KB a launch gets without opt-in
MAX_SMEM = 48 * 1024


def _check(ref_luma: torch.Tensor, cur_luma: torch.Tensor, m: int,
           s: int) -> None:
    if ref_luma.dtype != torch.float32 or cur_luma.dtype != torch.float32:
        raise ValueError("sad_search: lumas must be float32")
    if ref_luma.device != cur_luma.device:
        raise ValueError("sad_search: lumas on two devices")
    if m < 1 or s < 0:
        raise ValueError(f"sad_search: block {m}, range {s}")
    if ((m + 2 * s) ** 2 + m * m) * 8 > MAX_SMEM:
        raise ValueError(f"sad_search: block {m} with range {s} needs more "
                         f"than {MAX_SMEM} bytes of shared memory")


def sad_search_ref(ref_luma: torch.Tensor, cur_luma: torch.Tensor, m: int,
                   s: int):
    """Plain version of the kernel (the float64 full search)."""
    return motion.full_search(ref_luma, cur_luma, m, s)


def sad_search(ref_luma: torch.Tensor, cur_luma: torch.Tensor, m: int,
               s: int):
    """Full-search block ME, the contract of `ops.motion.full_search`."""
    _check(ref_luma, cur_luma, m, s)
    if _build.runs_plain(cur_luma):
        return sad_search_ref(ref_luma, cur_luma, m, s)
    motion._check_lumas(ref_luma, cur_luma, m)
    ref = ref_luma.contiguous()
    cur = cur_luma.contiguous()
    *lead, h, w = cur.shape
    g = cur.shape[0] if lead else 1
    dev = cur.device
    mv = torch.empty((*lead, h // m, w // m, 2), dtype=torch.int32,
                     device=dev)
    sad = torch.empty((*lead, h // m, w // m), dtype=torch.float32,
                      device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.vcf_sad_search(ref.data_ptr(), cur.data_ptr(), mv.data_ptr(),
                                sad.data_ptr(), g, h, w, m, s,
                                _build.stream_of(cur))
    _build.check(rc, "vcf_sad_search")
    sad_search.launches += 1
    return mv, sad


sad_search.launches = 0
