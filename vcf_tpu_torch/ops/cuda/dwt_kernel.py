"""The periodized DWT bank one level a kernel (no JAX counterpart).

`analyze_level(x, taps, ints, axis)`: one analysis level of float32 `x` on
the card over its rows at `axis` and its columns at `axis + 1` (leading
axes: frames; trailing axes: channels) -> (LL, (LH, HL, HH)), the views of
one stacked (2, 2, ..., H/2, W/2, ...) tensor, laid out as the plain
version's.  `synthesize_level(bands, taps, ints, axis)`: its inverse, one
contiguous tensor.  `ops.dwt.analyze_level` / `synthesize_level` route a
level here for a CUDA tensor and to their plain versions,
`ops.dwt.analyze_level_ref` / `synthesize_level_ref` (the float32 FMA
chains of `ops.dwt._fma_chain` evaluated exactly by `fma32` in float64
torch ops), for a CPU tensor; they check dtype and lengths, open the
`vcf.dwt.bank` span and derive `taps` and `ints` from the `Bank`
(`ops.dwt.kernel_args`).  These functions take CUDA tensors only.

It replaces no TPU kernel: vcf_tpu's bank (vcf_tpu/ops/dwt.py `_down_axis`
/ `_up_axis`) is XLA ops, and the port's plain version takes about a
dozen full-size float64 torch kernels a tap of every filter of every
pass, 97-98% of the DWT clip path's device time.  On the card a level is
bound by bytes: its input read once and its bands (or its output) written
once, 8 bytes an element, with ~20 FMAs an element of db5 far below the
float32 rate.  So each kernel (csrc/dwt.cu) stages a tile's input, halo
included, in shared memory once, runs both passes there and writes each
output once: one launch a level and direction (the plain version
launches hundreds on the card) and no float64 temporaries.  The chains are
`_rn` intrinsics in `_fma_chain`'s order, so kernel and plain version
agree bit for bit (synthesis skips the zero terms of the upsampled bands,
which can change only the sign of a zero sum; see csrc/dwt.cu).

Tile geometry is the C entry's, from the shape.  Callers hand contiguous
tensors on the cell's paths (the colour's output, each level's LL view
and the dequantized bands); a view that is not contiguous is copied
first.  `analyze_level.launches` and `synthesize_level.launches` count
the kernels' launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from vcf_tpu_torch.ops.cuda import _build


def level_dims(shape, axis: int, what: str) -> tuple:
    """(B, H, W, T) of a tensor with its rows at `axis`: the leading and
    the trailing axes flattened."""
    if axis < 0 or len(shape) < axis + 2:
        raise ValueError(f"{what}: no rows at axis {axis} and columns after "
                         f"them in {tuple(shape)}")
    for n in (math.prod(shape[:axis]), math.prod(shape[axis + 2:])):
        if n >= 2 ** 31:
            raise ValueError(f"{what}: {tuple(shape)} has 2^31 or more "
                             "frames or trailing elements")
    return (math.prod(shape[:axis]), shape[axis], shape[axis + 1],
            math.prod(shape[axis + 2:]))


@functools.lru_cache(maxsize=None)
def _tap_buffer(taps: tuple, device: torch.device) -> torch.Tensor:
    """A bank's float32 taps on `device`, made once a bank and device."""
    return torch.tensor(taps, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def _host_args(taps: tuple, ints: tuple) -> tuple:
    """The taps and the ints as the C entries take them (host), made once
    a bank and level size."""
    return (ctypes.c_float * len(taps))(*taps), (ctypes.c_int * len(ints))(
        *ints)


def _on_card(what: str, tensor: torch.Tensor) -> None:
    if _build.runs_plain(tensor):
        raise ValueError(f"{what}: the kernel takes CUDA tensors "
                         "(ops.dwt routes CPU tensors to the plain version)")


def _call(entry: str, dev: torch.device, *args) -> None:
    lib = _build.load()
    fn = getattr(lib, entry)
    if dev.index == torch.cuda.current_device():
        rc = fn(*args)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args)
    _build.check(rc, entry)


def analyze_level(x: torch.Tensor, taps: tuple, ints: tuple, axis: int):
    """float32 CUDA (..., H, W, ...), H and W even, with the taps and the
    eight ints of `ops.dwt.kernel_args` -> (LL, (LH, HL, HH))."""
    _on_card("analyze_level", x)
    b, h, w, t = level_dims(x.shape, axis, "analyze_level")
    out = torch.empty((2, 2) + x.shape[:axis] + (h // 2, w // 2)
                      + x.shape[axis + 2:], dtype=torch.float32,
                      device=x.device)
    if x.numel():
        x = x.contiguous()
        _call("vcf_dwt_analyze", x.device, x.data_ptr(), out.data_ptr(),
              _tap_buffer(taps, x.device).data_ptr(), *_host_args(taps, ints),
              b, h, w, t, _build.stream_of(x))
        analyze_level.launches += 1
    return out[0, 0], (out[1, 0], out[0, 1], out[1, 1])


def synthesize_level(bands: tuple, taps: tuple, ints: tuple,
                     axis: int) -> torch.Tensor:
    """LL, LH, HL, HH: float32 CUDA (..., h, w, ...) of one shape, with the
    taps and the four ints of `ops.dwt.kernel_args` -> (..., 2h, 2w,
    ...)."""
    ll = bands[0]
    _on_card("synthesize_level", ll)
    b, h, w, t = level_dims(ll.shape, axis, "synthesize_level")
    out = torch.empty(ll.shape[:axis] + (2 * h, 2 * w) + ll.shape[axis + 2:],
                      dtype=torch.float32, device=ll.device)
    if ll.numel():
        bands = [x.contiguous() for x in bands]
        _call("vcf_dwt_synthesize", ll.device,
              *(x.data_ptr() for x in bands), out.data_ptr(),
              _tap_buffer(taps, ll.device).data_ptr(), *_host_args(taps, ints),
              b, h, w, t, _build.stream_of(ll))
        synthesize_level.launches += 1
    return out


analyze_level.launches = 0
synthesize_level.launches = 0
