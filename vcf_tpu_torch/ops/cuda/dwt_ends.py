"""The two ends of the DWT clip path as kernels (no JAX counterpart).

`ops.dwt.DWT.clip_to_lanes` / `lanes_to_clip` take these for CUDA
tensors, around the bank's level kernels (`ops.cuda.dwt_kernel`):

- `color_in(frames, matrix, offset, multiple)`: u8 frames (N, H, W[, C])
  -> the bank's float32 (N, Hp, Wp[, C]) input: the cast,
  `ops.dct.pad_centered`'s zeros to multiples of `multiple`, minus
  `offset`, then the forward colour `matrix` (3 channels) as
  `ops.color.fma_rows`' FMA chain, or the cast alone (`matrix` None);
- `bands_to_lanes(bands, qss, sg, l)`: the bank's flat bands, each (N,
  ...) float32 -> the (G * sg * N, L) u8 lane grid of
  `entropy.dwt_device.bands_to_grid`, the deadzone quantizer and the byte
  planes of `DWT._byte_planes` applied on the way;
- `lanes_to_bands(lanes, qss, shapes)`: the grid, contiguous or K3's
  transposed view, read where it lies -> the dequantized float32 bands of
  `shapes` (`DWT._grid_flat` after `grid_to_bands`), views of one buffer;
- `color_out(x, matrix, offset, hw)`: the bank's float32 output -> u8
  frames (N, H, W[, C]): the inverse colour in `fma_rows`' float64 steps,
  plus `offset`, `ops.dct.unpad_centered`'s crop, the round half to
  even, the clamp and the u8 cast (`DWT._pixels` after the bank).

Their plain versions are those torch chains in `ops.dwt`, which a CPU
tensor takes; these functions take CUDA tensors only, and raise for
another device, a wrong dtype or a colour matrix without 3 channels.
They replace no TPU kernel (vcf_tpu's colour, quantizer and byte planes
are XLA ops); each kernel (csrc/dwt_ends.cu) is bound by bytes and reads
and writes each byte once, so the card path makes neither
`bands_to_grid`'s copy of the byte planes nor `grid_to_bands`' copy of
K3's transposed grid.  Each step is the plain version's own rounding:
kernels and plain versions agree bit for bit.  `color_in.launches`,
`bands_to_lanes.launches`, `lanes_to_bands.launches` and
`color_out.launches` count the launches.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from vcf_tpu_torch.ops.cuda import _build
from vcf_tpu_torch.ops.cuda.dwt_kernel import _call, _on_card


def _dtype(what: str, tensor: torch.Tensor, dtype: torch.dtype) -> None:
    if tensor.dtype != dtype:
        raise ValueError(f"{what}: {dtype} input, got {tensor.dtype}")


def _frames(what: str, x: torch.Tensor, matrix) -> tuple:
    """(N, H, W, C) of (N, H, W) or (N, H, W, C) frames; a colour matrix
    needs 3 channels."""
    if x.dim() not in (3, 4):
        raise ValueError(f"{what}: (N, H, W) or (N, H, W, C) frames, got "
                         f"{tuple(x.shape)}")
    n, h, w = x.shape[:3]
    c = x.shape[3] if x.dim() == 4 else 1
    if matrix is not None and (x.dim() != 4 or c != 3):
        raise ValueError(f"{what}: a colour matrix takes 3 channels, got "
                         f"{tuple(x.shape)}")
    return n, h, w, c


def _matrix(matrix):
    """The row-major 3 x 3 float32 matrix as the C entries take it (host),
    or None."""
    if matrix is None:
        return None
    m = np.asarray(matrix, np.float32)
    if m.shape != (3, 3):
        raise ValueError(f"colour matrix of shape {m.shape}, not (3, 3)")
    return (ctypes.c_float * 9)(*m.ravel().tolist())


def color_in(frames: torch.Tensor, matrix, offset: float,
             multiple: int) -> torch.Tensor:
    """u8 CUDA frames (N, H, W[, C]) at any strides -> float32 (N, Hp,
    Wp[, C]) contiguous, Hp and Wp the multiples of `multiple` at or above
    H and W, the frames centred (`pad_centered`)."""
    _on_card("color_in", frames)
    _dtype("color_in", frames, torch.uint8)
    n, h, w, c = _frames("color_in", frames, matrix)
    hp, wp = -(-h // multiple) * multiple, -(-w // multiple) * multiple
    out = torch.empty((n, hp, wp) + tuple(frames.shape[3:]),
                      dtype=torch.float32, device=frames.device)
    if frames.numel():
        strides = frames.stride() + ((0,) if frames.dim() == 3 else ())
        _call("vcf_dwt_color_in", frames.device, frames.data_ptr(),
              out.data_ptr(), n, h, w, c, *strides, hp, wp, _matrix(matrix),
              float(offset), _build.stream_of(frames))
        color_in.launches += 1
    return out


def color_out(x: torch.Tensor, matrix, offset: float, hw) -> torch.Tensor:
    """float32 CUDA (N, Hp, Wp[, C]) -> u8 (N, H, W[, C]) contiguous, (H,
    W) = `hw` cut from the centre (`unpad_centered`)."""
    _on_card("color_out", x)
    _dtype("color_out", x, torch.float32)
    n, hp, wp, c = _frames("color_out", x, matrix)
    h, w = hw
    if not (0 < h <= hp and 0 < w <= wp):
        raise ValueError(f"color_out: {h} x {w} frames from {hp} x {wp}")
    out = torch.empty((n, h, w) + tuple(x.shape[3:]), dtype=torch.uint8,
                      device=x.device)
    if out.numel():
        x = x.contiguous()
        _call("vcf_dwt_color_out", x.device, x.data_ptr(), out.data_ptr(), n,
              hp, wp, c, h, w, _matrix(matrix), float(offset),
              _build.stream_of(x))
        color_out.launches += 1
    return out


def bands_to_lanes(bands: list, qss: int, sg: int, l: int) -> torch.Tensor:
    """Flat float32 CUDA bands [LL, details...], each (N, ...) -> the
    (G * sg * N, L) u8 lane grid, G = len(bands) + 1: group 0 / 1 LL's
    index + 128 as its high / low byte, group i + 1 detail band i's index
    + 128 wrapped to a byte; each frame's block of a group holds its band's
    symbols, then 128."""
    _on_card("bands_to_lanes", bands[0])
    n = bands[0].shape[0]
    for b in bands:
        _dtype("bands_to_lanes", b, torch.float32)
        if b.device != bands[0].device or b.shape[0] != n:
            raise ValueError("bands_to_lanes: bands of one device and frame "
                             f"count, got {[tuple(x.shape) for x in bands]}")
    if l % 4:
        raise ValueError(f"bands_to_lanes: L = {l} is not a multiple of 4")
    bands = [b.contiguous() for b in bands]
    sizes = [b.numel() // n for b in bands]
    grid = torch.empty(((len(bands) + 1) * sg * n, l), dtype=torch.uint8,
                       device=bands[0].device)
    if grid.numel():
        ptrs = (ctypes.c_void_p * len(bands))(*(b.data_ptr() for b in bands))
        _call("vcf_dwt_quantize_grid", grid.device, ptrs,
              (ctypes.c_int * len(sizes))(*sizes), len(bands), n, sg, l,
              float(qss), grid.data_ptr(), _build.stream_of(grid))
        bands_to_lanes.launches += 1
    return grid


def dequantize_mode(lanes: torch.Tensor) -> str:
    """The axis `vcf_dwt_dequantize_mode` stages a tile along for a grid:
    "steps" for K3's transposed (S, L) view (a stride of 1 along the
    steps, not along the lanes), else "lanes"."""
    ss, sl = lanes.stride()
    return "steps" if ss == 1 and sl != 1 else "lanes"


def lanes_to_bands(lanes: torch.Tensor, qss: int, shapes: list) -> list:
    """(G * sg * N, L) u8 CUDA lanes at any strides, G = len(shapes) + 1
    -> the float32 bands of `shapes` (each (N, ...)), dequantized:
    contiguous views of one buffer."""
    _on_card("lanes_to_bands", lanes)
    _dtype("lanes_to_bands", lanes, torch.uint8)
    if lanes.dim() != 2:
        raise ValueError(f"lanes_to_bands: (S, L) lanes, got "
                         f"{tuple(lanes.shape)}")
    n = shapes[0][0]
    sizes = [math.prod(s[1:]) for s in shapes]
    s_streams, l = lanes.shape
    sg = s_streams // ((len(shapes) + 1) * n)
    if sg * (len(shapes) + 1) * n != s_streams:
        raise ValueError(f"lanes_to_bands: {s_streams} lanes are not "
                         f"{len(shapes) + 1} groups of {n} frames")
    flat = torch.empty(n * sum(sizes), dtype=torch.float32,
                       device=lanes.device)
    if flat.numel():
        _call("vcf_dwt_dequantize_grid", lanes.device, lanes.data_ptr(),
              *lanes.stride(), (ctypes.c_int * len(sizes))(*sizes),
              len(sizes), n, sg, l, float(qss), flat.data_ptr(),
              _build.stream_of(lanes))
        lanes_to_bands.launches += 1
    return [part.view(s) for part, s in
            zip(flat.split([n * m for m in sizes]), shapes)]


color_in.launches = 0
bands_to_lanes.launches = 0
lanes_to_bands.launches = 0
color_out.launches = 0
