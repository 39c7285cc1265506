"""Fused block-DCT + deadzone quantizer kernels B1-B4 (port of
vcf_tpu/ops/pallas/dct_kernel.py).

B1 `fused_dct_quantize` replaces the Pallas function of the same name
(and its `_any` pad-and-crop wrapper): (C, H, W) float32 planes -> 8x8
(b x b) block DCT -> optional JPEG-table prescale -> trunc(c * (1/qss))
+ offset -> clip -> (C, H, W) uint8 indexes.
B2 `fused_dequantize_idct` is its inverse: (k - offset) * qss -> optional
true divide by the table -> inverse DCT -> (C, H, W) float32.
B3 `fused_cdct_quantize`: (3, H, W) uint8 pixels - offset -> 3x3 color
forward -> B1, uint8 in and out.
B4 `fused_dequantize_cdct`: B2 -> 3x3 color inverse -> + offset ->
round half to even -> clip -> (3, H, W) uint8 pixels.

Every function also takes a leading frame axis (N, C, H, W), where
vcf_tpu used jax.vmap, so one launch covers a clip.  The kernels take
any H, W that are multiples of b, for every b that divides 32; the
TPU's 32-row / 128-lane tiling gates (`supports`) and the pad-and-crop
of the `_any` wrappers have no counterpart, so the `_any` names call the
same functions (and, as vcf_tpu's, refuse `grid_layout` where they
would have padded).

`grid_layout=True` is vcf_tpu's subband-grid tile layout: inside each
(ROWS=32, cw) tile of the index planes, rows go in (coeff_y, block_y)
order and columns in (coeff_x, block_x) order, cw = `_chunk_w(W, b)`
(128 at W = 1920).  cw is a layout constant, not a memory gate: it fixes
the lane order of `entropy.rans.grid_lanes`, and so the wire bytes.  The
kernels permute only their store (forward) or load (inverse) index, so
a grid-layout output equals the block-layout output permuted bit for
bit; the plain versions permute the block layout (`to_grid`,
`from_grid`).  It needs H % 32 == 0.

Each wrapper runs its plain torch version for a CPU tensor and launches
its CUDA kernel (csrc/dct.cu) for a CUDA tensor; nothing else.  The
plain versions follow the kernels' op order: color rows left to right,
vertical DCT pass before the horizontal one, quantize by a multiply with
the float32 reciprocal of qss, divide by the perceptual table on
decode.  Kernel against plain version follows the +-1 rule (float32
sums in another order), not bit-exactness.  `launches` counts kernel
launches, `grid_launches` those in the grid layout.  A launch runs in a
`vcf.dct.forward` or `vcf.dct.inverse` span, the copy of an input that
is not contiguous in `vcf.dct.layout`, its bytes counted in
`layout_bytes` (`utils.profiling`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from vcf_tpu_torch.ops import dct as dct_ops
from vcf_tpu_torch.ops.cuda import _build
from vcf_tpu_torch.utils import profiling

BLOCK_SIZES = (1, 2, 4, 8, 16, 32)
ROWS = 32  # tile rows of the subband-grid layout
CW = 512   # widest lane chunk of the subband-grid layout


def _chunk_w(w: int, b: int) -> int:
    """The subband-grid tile width of a W-wide plane (vcf_tpu
    dct_kernel.py `_chunk_w`, verbatim)."""
    cw = min(w, CW)
    while w % cw:
        cw //= 2
    return max(cw, b)


def _grid_cw(x: torch.Tensor, b: int, what: str) -> int:
    """cw of the grid layout of x (..., H, W); raise unless it tiles."""
    h, w = x.shape[-2:]
    cw = _chunk_w(w, b)
    if h % ROWS or w % cw:
        raise ValueError(f"{what}: grid_layout needs H % {ROWS} == 0 and "
                         f"W % {cw} == 0, got {h}x{w}")
    return cw


def _grid_view(x: torch.Tensor, b: int, cw: int, rows_first: bool
               ) -> torch.Tensor:
    """Swap the (block, coeff) pair of both tile axes of (..., H, W).
    rows_first: x is in block layout, viewed as (block, coeff) pairs."""
    *lead, h, w = x.shape
    nr, nc = ROWS // b, cw // b
    shape = ((nr, b, w // cw, nc, b) if rows_first
             else (b, nr, w // cw, b, nc))
    y = x.reshape(*lead, h // ROWS, *shape)
    return y.transpose(-5, -4).transpose(-2, -1).reshape(x.shape)


def to_grid(x: torch.Tensor, b: int) -> torch.Tensor:
    """Block-layout planes (..., H, W) -> the subband-grid tile layout:
    new tile index g * (n / b) + blk holds old blk * b + g (vcf_tpu
    `_grid_perm`), along the 32 tile rows and the cw tile columns."""
    return _grid_view(x, b, _grid_cw(x, b, "to_grid"), rows_first=True)


def from_grid(x: torch.Tensor, b: int) -> torch.Tensor:
    """Inverse of `to_grid`."""
    return _grid_view(x, b, _grid_cw(x, b, "from_grid"), rows_first=False)


def static_mat(m) -> tuple:
    """3x3 color matrix -> nested tuple of floats, the `m` argument of the
    color-fused functions (each entry a float32 value)."""
    return tuple(tuple(float(v) for v in row)
                 for row in np.asarray(m, np.float32))


def _recip(qss: int) -> float:
    """float32(1 / qss) as a Python float, the kernels' quantizer step."""
    return float(np.float32(1.0 / qss))


def _check(x: torch.Tensor, dtype, b: int, what: str,
           channels: Optional[int] = None) -> None:
    if x.dtype != dtype or x.dim() not in (3, 4):
        raise ValueError(f"{what}: expected (C, H, W) or (N, C, H, W) "
                         f"{dtype}, got {x.dtype} {tuple(x.shape)}")
    if b not in BLOCK_SIZES:
        raise ValueError(f"{what}: block size {b} does not divide 32")
    c, h, w = x.shape[-3:]
    if h % b or w % b:
        raise ValueError(f"{what}: {h}x{w} is not a multiple of b={b}")
    if channels is not None and c != channels:
        raise ValueError(f"{what}: expected {channels} channels, got {c}")


# ---------------------------------------------------------------------------
# Plain torch building blocks (planar (..., H, W) layout)
# ---------------------------------------------------------------------------

def _dct_fwd(x: torch.Tensor, b: int) -> torch.Tensor:
    """Blockwise D @ X @ D^T of (..., H, W) float32, vertical pass first."""
    *lead, h, w = x.shape
    d = torch.from_numpy(dct_ops.dct_matrix(b)).to(x.device)
    xb = x.reshape(*lead, h // b, b, w // b, b)
    y = torch.einsum("ur,...yrxs->...yuxs", d, xb)
    y = torch.einsum("vs,...yuxs->...yuxv", d, y)
    return y.reshape(*lead, h, w)


def _dct_inv(c: torch.Tensor, b: int) -> torch.Tensor:
    """Blockwise D^T @ C @ D of (..., H, W) float32, vertical pass first."""
    *lead, h, w = c.shape
    d = torch.from_numpy(dct_ops.dct_matrix(b)).to(c.device)
    cb = c.reshape(*lead, h // b, b, w // b, b)
    y = torch.einsum("ur,...yuxv->...yrxv", d, cb)
    y = torch.einsum("vs,...yrxv->...yrxs", d, y)
    return y.reshape(*lead, h, w)


def _percep_planes(c: int, b: int, device) -> torch.Tensor:
    """(C, b, b) perceptual tables: luma for channel 0, chroma after."""
    luma, chroma = dct_ops.perceptual_tables(b)
    return torch.from_numpy(np.stack([luma] + [chroma] * (c - 1))).to(device)


def _percep_apply(coeff: torch.Tensor, b: int, inverse: bool) -> torch.Tensor:
    *lead, c, h, w = coeff.shape
    t = _percep_planes(c, b, coeff.device)[:, None, :, None, :]
    x = coeff.reshape(*lead, c, h // b, b, w // b, b)
    x = x / t if inverse else x * t
    return x.reshape(coeff.shape)


def _quantize(coeff: torch.Tensor, qss: int, offset: int) -> torch.Tensor:
    k = torch.trunc(coeff * _recip(qss)).to(torch.int32) + offset
    # Deadzone_Quantizer(min_val=0, max_val=255) saturates, not wraps
    # (src/deadzone.py:64)
    return torch.clamp(k, 0, 255).to(torch.uint8)


def _dequantize(k_u8: torch.Tensor, qss: int, offset: int) -> torch.Tensor:
    return (k_u8.to(torch.int32) - offset).to(torch.float32) * qss


def _color(x: torch.Tensor, m: Sequence[Sequence[float]]) -> torch.Tensor:
    """Rows of the 3x3 matrix over the channel axis (-3), left to right."""
    xs = [x[..., i, :, :] for i in range(3)]
    return torch.stack([m[d][0] * xs[0] + m[d][1] * xs[1] + m[d][2] * xs[2]
                        for d in range(3)], dim=-3)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def fused_dct_quantize_ref(planes: torch.Tensor, b: int = 8, qss: int = 32,
                           offset: int = 128, perceptual: bool = False,
                           grid_layout: bool = False) -> torch.Tensor:
    coeff = _dct_fwd(planes, b)
    if perceptual:
        coeff = _percep_apply(coeff, b, inverse=False)
    k = _quantize(coeff, qss, offset)
    return to_grid(k, b) if grid_layout else k


def fused_dequantize_idct_ref(planes_u8: torch.Tensor, b: int = 8,
                              qss: int = 32, offset: int = 128,
                              perceptual: bool = False,
                              grid_layout: bool = False) -> torch.Tensor:
    if grid_layout:
        planes_u8 = from_grid(planes_u8, b)
    coeff = _dequantize(planes_u8, qss, offset)
    if perceptual:
        coeff = _percep_apply(coeff, b, inverse=True)
    return _dct_inv(coeff, b)


def fused_cdct_quantize_ref(planes: torch.Tensor, m, b: int = 8,
                            qss: int = 32, offset: int = 128,
                            grid_layout: bool = False) -> torch.Tensor:
    ct = _color(planes.to(torch.float32) - offset, m)
    k = _quantize(_dct_fwd(ct, b), qss, offset)
    return to_grid(k, b) if grid_layout else k


def fused_dequantize_cdct_ref(planes_u8: torch.Tensor, m, b: int = 8,
                              qss: int = 32, offset: int = 128,
                              grid_layout: bool = False) -> torch.Tensor:
    if grid_layout:
        planes_u8 = from_grid(planes_u8, b)
    ct = _dct_inv(_dequantize(planes_u8, qss, offset), b)
    pix = _color(ct, m) + offset
    return torch.clamp(torch.round(pix).to(torch.int32), 0, 255
                       ).to(torch.uint8)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _device_tables(b: int, device: torch.device) -> torch.Tensor:
    """The (2, b, b) luma and chroma perceptual tables on `device`,
    uploaded once per (b, device)."""
    return torch.from_numpy(np.stack(dct_ops.perceptual_tables(b))).to(device)


@functools.lru_cache(maxsize=None)
def _host_dct(b: int):
    """The b x b DCT matrix as a C float array: both kernels take it by
    value (it reaches the kernel as a launch parameter, with no copy of its
    own)."""
    return (ctypes.c_float * (b * b))(*dct_ops.dct_matrix(b).ravel().tolist())


def _launch(entry: str, x: torch.Tensor, out: torch.Tensor, b: int,
            step: float, offset: int, perceptual: bool, m, cw: int) -> None:
    """Call one C entry of csrc/dct.cu; x and the fresh `out` are
    (C, H, W) or (N, C, H, W); cw is 0 (block layout) or the grid
    layout's chunk width."""
    lib = _build.load()
    if not x.is_contiguous():
        # e.g. the planar view of an (N, H, W, 3) clip
        with profiling.span("vcf.dct.layout"):
            x = x.contiguous()
        profiling.count("layout_bytes", 2 * x.nbytes)
    n = x.shape[0] if x.dim() == 4 else 1
    c, h, w = x.shape[-3:]
    tables = _device_tables(b, x.device).data_ptr() if perceptual else None
    mat = None
    if m is not None:
        mat = (ctypes.c_float * 9)(*[v for row in m for v in row])
    with torch.cuda.device(x.device):
        rc = getattr(lib, entry)(
            x.data_ptr(), out.data_ptr(), _host_dct(b), tables, mat,
            n, c, h, w, b, step, offset, cw, _build.stream_of(x))
    _build.check(rc, entry)


_SPANS = {"vcf_dct_forward": "vcf.dct.forward",
          "vcf_dct_inverse": "vcf.dct.inverse"}


def _run(fn, entry: str, x: torch.Tensor, out_dtype, b: int, step: float,
         offset: int, perceptual: bool, m, grid_layout: bool) -> torch.Tensor:
    """Launch one kernel for the CUDA tensor x and count it on `fn`."""
    cw = _grid_cw(x, b, fn.__name__) if grid_layout else 0
    with profiling.span(_SPANS[entry]):
        out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
        _launch(entry, x, out, b, step, offset, perceptual, m, cw)
    fn.launches += 1
    fn.grid_launches += bool(grid_layout)
    return out


def fused_dct_quantize(planes: torch.Tensor, b: int = 8, qss: int = 32,
                       offset: int = 128, perceptual: bool = False,
                       grid_layout: bool = False) -> torch.Tensor:
    """(C, H, W) or (N, C, H, W) float32 -> uint8 quantization indexes,
    block layout (subband reordering stays outside) or, with
    grid_layout, the subband-grid tile layout.  perceptual=True
    multiplies the coefficients by the JPEG tables before the quantizer
    (luma for channel 0, chroma for the others)."""
    _check(planes, torch.float32, b, "fused_dct_quantize")
    if _build.runs_plain(planes):
        return fused_dct_quantize_ref(planes, b, qss, offset, perceptual,
                                      grid_layout)
    return _run(fused_dct_quantize, "vcf_dct_forward", planes, torch.uint8,
                b, _recip(qss), offset, perceptual, None, grid_layout)


def fused_dequantize_idct(planes_u8: torch.Tensor, b: int = 8, qss: int = 32,
                          offset: int = 128, perceptual: bool = False,
                          grid_layout: bool = False) -> torch.Tensor:
    """(C, H, W) or (N, C, H, W) uint8 indexes (in the grid layout with
    grid_layout) -> float32 planes (color inverse and +offset stay
    outside).  perceptual=True divides the dequantized coefficients by
    the JPEG tables."""
    _check(planes_u8, torch.uint8, b, "fused_dequantize_idct")
    if _build.runs_plain(planes_u8):
        return fused_dequantize_idct_ref(planes_u8, b, qss, offset,
                                         perceptual, grid_layout)
    return _run(fused_dequantize_idct, "vcf_dct_inverse", planes_u8,
                torch.float32, b, float(qss), offset, perceptual, None,
                grid_layout)


def fused_cdct_quantize(planes: torch.Tensor, m, b: int = 8, qss: int = 32,
                        offset: int = 128,
                        grid_layout: bool = False) -> torch.Tensor:
    """(3, H, W) or (N, 3, H, W) uint8 pixels -> uint8 quantization
    indexes (block or grid layout) with the color forward fused in; `m`
    is the 3x3 forward matrix (`static_mat`)."""
    _check(planes, torch.uint8, b, "fused_cdct_quantize", channels=3)
    if _build.runs_plain(planes):
        return fused_cdct_quantize_ref(planes, m, b, qss, offset, grid_layout)
    return _run(fused_cdct_quantize, "vcf_dct_forward", planes, torch.uint8,
                b, _recip(qss), offset, False, m, grid_layout)


def fused_dequantize_cdct(planes_u8: torch.Tensor, m, b: int = 8,
                          qss: int = 32, offset: int = 128,
                          grid_layout: bool = False) -> torch.Tensor:
    """(3, H, W) or (N, 3, H, W) uint8 indexes (block or grid layout) ->
    uint8 pixels with the color inverse and round/clip fused in; `m` is
    the 3x3 INVERSE matrix (`static_mat`)."""
    _check(planes_u8, torch.uint8, b, "fused_dequantize_cdct", channels=3)
    if _build.runs_plain(planes_u8):
        return fused_dequantize_cdct_ref(planes_u8, m, b, qss, offset,
                                         grid_layout)
    return _run(fused_dequantize_cdct, "vcf_dct_inverse", planes_u8,
                torch.uint8, b, float(qss), offset, False, m, grid_layout)


for _fn in (fused_dct_quantize, fused_dequantize_idct, fused_cdct_quantize,
            fused_dequantize_cdct):
    _fn.launches = 0
    _fn.grid_launches = 0


def _any_check(x: torch.Tensor, grid_layout: bool, what: str) -> None:
    """vcf_tpu's `_any` wrappers pad to 32-row / 128-column tiles and
    refuse grid_layout where they would pad."""
    h, w = x.shape[-2:]
    if grid_layout and (h % ROWS or w % 128):
        raise ValueError(f"{what}: grid_layout requires kernel-native "
                         f"shapes, got {h}x{w}")


def fused_dct_quantize_any(planes: torch.Tensor, b: int = 8, qss: int = 32,
                           offset: int = 128, perceptual: bool = False,
                           grid_layout: bool = False) -> torch.Tensor:
    """vcf_tpu's pad-and-crop name: the kernel takes any block-multiple
    shape, so this is `fused_dct_quantize` (grid_layout as vcf_tpu's)."""
    _any_check(planes, grid_layout, "fused_dct_quantize_any")
    return fused_dct_quantize(planes, b, qss, offset, perceptual, grid_layout)


def fused_dequantize_idct_any(planes_u8: torch.Tensor, b: int = 8,
                              qss: int = 32, offset: int = 128,
                              perceptual: bool = False,
                              grid_layout: bool = False) -> torch.Tensor:
    """`fused_dequantize_idct` under vcf_tpu's pad-and-crop name."""
    _any_check(planes_u8, grid_layout, "fused_dequantize_idct_any")
    return fused_dequantize_idct(planes_u8, b, qss, offset, perceptual,
                                 grid_layout)
