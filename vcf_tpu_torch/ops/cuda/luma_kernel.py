"""The luma of the planar IPP loop as one kernel (no JAX counterpart).

`luma(x, channel_axis, round=False)`: RGB pixels, uint8 or float32
holding integers, with a 3-channel axis -> float32 luma, that axis
removed, contiguous: the float32 fused multiply-add chain
fma(x2, w2, fma(x1, w1, x0 * w0)) of `ops.motion.to_luma`, with
`motion.LUMA_WEIGHTS`; `round` rounds each channel half to even first
(`torch.round`).  Its plain version is `luma_ref`: `to_luma`, after
`torch.round` when `round`.

It replaces no TPU kernel: vcf_tpu's planar IPP loop takes its lumas as
an XLA dot (vcf_tpu/video/ipp.py:409-410), and the port evaluated the
chain as ~12 float64 torch kernels a luma (`ops.color.fma_rows`), the
largest item of the loop.  On the card it is bound by bytes: a (G, 3, H,
W) float32 frame read once and a float32 plane written once.  The kernel
(`luma_kernel` in csrc/motion.cu) reads the input where it lies, planar
(G, 3, H, W) or a channels-last view (G, H, W, 3) with a pixel stride of
3 (a frame of a (G, T, H, W, 3) clip), so no layout copy or cast comes
first: a thread takes 4 pixels as three aligned loads of 4 elements (one
a channel, or the group's 12 interleaved elements) and writes their
lumas as one 16-byte store, a warp's stores one contiguous run.
`launch_mode` (the C entry `vcf_luma_mode`'s choice, by the input's
pointer and strides) sends every other layout, W % 4 != 0 and views off
that alignment to the kernel's scalar mode, a thread a pixel, counted in
`luma.generic_launches`.  The chain's steps are `_rn` intrinsics, and
for pixel-sized integers fma_rows' float64 steps round as they do, so
kernel and plain version agree bit for bit.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel;
any other device, dtype or channel count raises.  `luma.launches` counts
the kernel's launches.
"""

from __future__ import annotations

import torch

from vcf_tpu_torch.ops import motion
from vcf_tpu_torch.ops.cuda import _build

#: the input dtypes and their codes in the C entry
DTYPES = {torch.float32: 0, torch.uint8: 1}
#: the three float32 weights, as the plain version multiplies by them
WEIGHTS = tuple(float(w) for w in motion.LUMA_WEIGHTS)


def luma_ref(x: torch.Tensor, channel_axis: int = -1,
             round: bool = False) -> torch.Tensor:
    """Plain version of `luma`."""
    if round and x.is_floating_point():
        x = torch.round(x)
    return motion.to_luma(x, channel_axis)


def frames_of(x: torch.Tensor, channel_axis: int):
    """x as (G, H, W, 3) (a view unless its leading axes do not merge) and
    its strides in elements (g, c, h, w), 0 for an axis of size 1."""
    xs = x.movedim(channel_axis, -1)
    while xs.dim() < 3:
        xs = xs.unsqueeze(0)
    xs = xs.reshape(-1, *xs.shape[-3:])
    sg, sh, sw, sc = (s if n > 1 else 0
                      for s, n in zip(xs.stride(), xs.shape))
    return xs, (sg, sc, sh, sw)


def launch_mode(ptr: int, dtype: torch.dtype, shape, strides) -> str:
    """The mode `vcf_luma_mode` picks for (G, H, W) pixels at `ptr` with
    `frames_of`'s strides: "planar" or "channels_last" (the vector modes:
    W % 4 == 0, the input and its frames', rows' (and, planar, channels')
    offsets aligned to a quad of 4 elements, 16 bytes of float32 or 4 of
    uint8, fewer than 2^31 groups of 4 pixels), else "scalar"."""
    (g, h, w), (sg, sc, sh, sw) = shape, strides
    es = 4 if dtype == torch.float32 else 1
    quad = 4 * es
    if (w % 4 or ptr % quad or (sg * es) % quad or (sh * es) % quad
            or g * h * (w // 4) >= 2 ** 31):
        return "scalar"
    if sw == 1 and (sc * es) % quad == 0:
        return "planar"
    if sc == 1 and sw == 3:
        return "channels_last"
    return "scalar"


def _check(x: torch.Tensor, channel_axis: int) -> None:
    if x.dtype not in DTYPES:
        raise ValueError(f"luma: float32 or uint8 pixels, got {x.dtype}")
    if x.dim() == 0 or x.shape[channel_axis] != 3:
        raise ValueError(f"luma: axis {channel_axis} of {tuple(x.shape)} "
                         "is not 3 channels")


def _launch(x: torch.Tensor, channel_axis: int, round: bool) -> torch.Tensor:
    dev = x.device
    shape = x.movedim(channel_axis, -1).shape[:-1]
    if x.numel() == 0:
        return torch.empty(shape, dtype=torch.float32, device=dev)
    xs, strides = frames_of(x, channel_axis)
    g, h, w, _ = xs.shape
    out = torch.empty((g, h, w), dtype=torch.float32, device=dev)
    args = (xs.data_ptr(), out.data_ptr(), DTYPES[x.dtype], g, h, w,
            *strides, *WEIGHTS, int(round), _build.stream_of(x))
    lib = _build.load()
    if dev.index == torch.cuda.current_device():
        rc = lib.vcf_luma(*args)
    else:
        with torch.cuda.device(dev):
            rc = lib.vcf_luma(*args)
    _build.check(rc, "vcf_luma")
    luma.launches += 1
    if launch_mode(xs.data_ptr(), x.dtype, (g, h, w), strides) == "scalar":
        luma.generic_launches += 1
    return out.reshape(shape)


def luma(x: torch.Tensor, channel_axis: int = -1,
         round: bool = False) -> torch.Tensor:
    """(..., 3, ...) uint8 or float32 pixels, the channels on
    `channel_axis` -> (...) float32 luma, contiguous."""
    _check(x, channel_axis)
    if _build.runs_plain(x):
        return luma_ref(x, channel_axis, round)
    return _launch(x, channel_axis, round)


luma.launches = 0
luma.generic_launches = 0
