"""Full-search block SAD motion estimation kernel (port of
vcf_tpu/ops/pallas/sad_kernel.py).

`sad_search` replaces both Pallas functions, `sad_search` (:58) and the
row-tiled `sad_search_tiled` (:141): (H, W) or (G, H, W) float32 lumas ->
(mv (..., nby, nbx, 2) int32 (dy, dx) of the first minimum in row-major
order, sad (..., nby, nbx) float32).  The TPU's tiles, `tile_h` and VMEM
gates have no counterpart; the argmin is fused into the kernel.

Design (csrc/motion.cu).  For the block sizes in `INSTANCES` a CTA stages
several adjacent blocks and the union of their reference windows in shared
memory, in float32; a thread sums one dy and a run of 17 (or 9) dx values,
the current and reference values of a row chunk in registers, so the adds
set the pace and not the shared-memory loads.  The sums are a float32
screen (twice the float64 add rate): every displacement whose float32 sum
F_d lies within the rounding bound of the block's smallest
(`screen_bound`) is summed again in float64, and the (sad, d) minimum of
those is the answer.  A CTA sums its candidates a warp an item, or a
thread an item once many tie (flat content under a change of light);
`count_refined` reports both counts.  Other block sizes take the generic
mode, the first design (one CTA per block, one thread per displacement,
float64, the window staged in shared memory).  Past the shared-memory
gates every block size takes the generic kernel's global mode, which reads
each term from global memory and so takes every range.  Both generic modes
count in `sad_search.generic_launches`.

Exactness: every nonzero luma is a multiple of 2^-27 and a block's SAD is
< 2^18 (m <= 32; < 2^26 for the generic modes' m <= 512), so a float64
sum of |a - b| is exact in any order, and every minimiser passes the
screen.  A CPU tensor runs the plain version,
`sad_search_ref` (which is `ops.motion.full_search`); a CUDA tensor
launches the kernel.  They agree bit for bit: mvs and SADs.
`sad_search.launches` counts kernel launches of both modes; a search
runs in a `vcf.motion.search` span (`utils.profiling`).

Shared memory: on the card `vcf_sad_mode` picks the mode of (m, s): the
instance or the staged generic mode where their shared memory fits
(`vcf_sad_smem`: every shape the first design took, its float64 window
and block in 48 KiB, and at the instances larger ranges), else the global
mode, so the card takes every m >= 1 and s >= 0.  The plain version keeps
the first design's gate.  `fits(m, s, device)` is the gate of `device`;
`sad_search` raises past it, and `IPPCodec._make_search` takes the full
search there instead (on the CPU only).
"""

from __future__ import annotations

import math

import torch

from vcf_tpu_torch.ops import motion
from vcf_tpu_torch.ops.cuda import _build
from vcf_tpu_torch.utils import profiling

#: block sizes with a kernel instance; others take the generic mode
INSTANCES = (4, 8, 16, 32)
#: the first design's shared memory: the (m + 2s)^2 window and the m x m
#: block in float64, within the 48 KiB a launch gets without opt-in
FIRST_DESIGN_SMEM = 48 * 1024


def screen_bound(m: int) -> float:
    """Relative bound g on the float32 screen's error for an m x m block:
    |F - S| <= g S for the recursive float32 sum F of the m^2 terms
    fl(|a - b|) against their exact sum S, g = (m^2 + 1) u / (1 - (m^2 + 1)
    u), u = 2^-24; rounded up.  The kernel keeps as candidates the d with
    F_d <= F_min (1 + g) / (1 - g), the factor rounded up in float32."""
    nu = (m * m + 1) * 2.0 ** -24
    return math.nextafter(nu / (1.0 - nu), math.inf)


def fits(m: int, s: int, device) -> bool:
    """True where `sad_search` takes block m and range s (m >= 1, s >= 0)
    on `device`: on the CPU the first design's gate (its float64 window
    and block in 48 KiB); on CUDA every (m, s) (`vcf_sad_mode`)."""
    if _build.plain_on(device):
        return ((m + 2 * s) ** 2 + m * m) * 8 <= FIRST_DESIGN_SMEM
    return _build.load().vcf_sad_mode(m, s) >= 0


def _check(ref_luma: torch.Tensor, cur_luma: torch.Tensor, m: int,
           s: int) -> None:
    if ref_luma.dtype != torch.float32 or cur_luma.dtype != torch.float32:
        raise ValueError("sad_search: lumas must be float32")
    if ref_luma.device != cur_luma.device:
        raise ValueError("sad_search: lumas on two devices")
    if m < 1 or s < 0:
        raise ValueError(f"sad_search: block {m}, range {s}")
    if not fits(m, s, cur_luma.device):
        raise ValueError(f"sad_search: block {m} with range {s} needs more "
                         "shared memory than the kernel has")


def sad_search_ref(ref_luma: torch.Tensor, cur_luma: torch.Tensor, m: int,
                   s: int):
    """Plain version of the kernel (the float64 full search)."""
    return motion.full_search(ref_luma, cur_luma, m, s)


def _launch(ref_luma, cur_luma, m, s, n_refined=None):
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
        rc = lib.vcf_sad_search(
            ref.data_ptr(), cur.data_ptr(), mv.data_ptr(), sad.data_ptr(),
            None if n_refined is None else n_refined.data_ptr(), g, h, w, m,
            s, _build.stream_of(cur))
    _build.check(rc, "vcf_sad_search")
    sad_search.launches += 1
    if lib.vcf_sad_mode(m, s) != 0:
        sad_search.generic_launches += 1
    return mv, sad


def sad_search(ref_luma: torch.Tensor, cur_luma: torch.Tensor, m: int,
               s: int):
    """Full-search block ME, the contract of `ops.motion.full_search`."""
    _check(ref_luma, cur_luma, m, s)
    with profiling.span("vcf.motion.search"):
        if _build.runs_plain(cur_luma):
            return sad_search_ref(ref_luma, cur_luma, m, s)
        return _launch(ref_luma, cur_luma, m, s)


sad_search.launches = 0
sad_search.generic_launches = 0


def count_refined(ref_luma: torch.Tensor, cur_luma: torch.Tensor, m: int,
                  s: int):
    """`sad_search` on CUDA lumas -> (mv, sad, refined, by_thread): also how
    many displacements the screen summed again in float64, and how many
    CTAs summed them a thread an item (both 0 in the generic mode)."""
    _check(ref_luma, cur_luma, m, s)
    if _build.runs_plain(cur_luma):
        raise ValueError("count_refined: the screen runs only on CUDA")
    n = torch.zeros(2, dtype=torch.int64, device=cur_luma.device)
    mv, sad = _launch(ref_luma, cur_luma, m, s, n)
    refined, by_thread = n.tolist()
    return mv, sad, refined, by_thread
