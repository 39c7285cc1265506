"""Plain reference of VCF's 2D-DWT intra composition, as the
`iii-dwt-cgrans-1080p` configuration states it, in float64.

Encode: u8 pixels (N, H, W, 3) -> minus 128 -> YCoCg (src/YCoCg.py) ->
`levels` levels of the periodized db5 analysis over rows and columns ->
the deadzone quantizer k = trunc(c / qss) -> byte planes -> the clip's
lane grid.  Decode: the grid -> k * qss -> synthesis -> inverse YCoCg ->
plus 128, rounded half to even and clipped to 0..255.

- db5 is Daubechies' published lowpass (Ten Lectures on Wavelets, 1992,
  Table 6.1, N = 5, normalized to sum sqrt(2)), `DB5` below in the
  table's order; the highpass is g[k] = (-1)^k h[9 - k].
- Analysis: a[k] = sum_j f[j] * x[(2k + j + shift) mod n], shift 0 for
  both filters, along the rows, then along the columns of each half
  (LL, LH, HL, HH: LH is the rows' lowpass then the columns' highpass).
- Synthesis: y[m] = sum_j f[j] * a_up[(m - j - phase) mod n], a_up[2k] =
  a[k] and 0 between, phase 0, the lowpass and highpass halves added,
  first along the columns, then along the rows.
- Byte planes: LL's (k + 128) & 0xFFFF as two planes (high byte, then
  low byte), each detail band's (k + 128) & 0xFF: the wrap of VCF's
  uint16 and uint8 casts (src/2D-DWT.py:162-200).
- The grid: G = 2 + 3 * levels groups in the order LL high, LL low, then
  the detail bands coarsest first (LH, HL, HH of each level); one
  frame's band sizes give sg lanes a group (the largest power of two at
  or below ~512 symbols a lane, at least 8) and L steps (the largest
  band over sg, rounded up to a multiple of 4); group i holds band i's
  (sg, L) block of frame 0, then of frame 1, ...; lane j of a block codes
  the band's (h, w, c)-raster symbols [j * L, (j + 1) * L), padded with
  128.

Departures from the published description, each deliberate:
- Boundaries are periodized (pywt's 'periodization' mode halves every
  band exactly), at the phase above: pywt convolves with the reversed
  filter and centres it, so its subbands are these shifted by a few
  samples.  VCF writes each subband to its own file; here the bands are
  the groups of one lane grid coded by one stream.
- Frames whose sides are not multiples of 2^levels are zero-padded,
  centred, before the 128 is taken off (none at 1088 x 1920).
- The taps are the published float64 values; the program rounds them to
  float32 and evaluates each sum as float32 fused multiply-adds.

`tf32=True` is the control: both operands of every product of the bank
and of the colour transform are rounded to TF32 (10 explicit mantissa
bits) first, what a tensor core does with float32 inputs when TF32 is
allowed.  Plain torch only: no kernel, no import of the code under test.
"""

from __future__ import annotations

import torch

from portbench.reference.transform import YCOCG_FWD, YCOCG_INV, round_tf32

OFFSET = 128
DB5 = (0.1601023979741929, 0.6038292697971895, 0.7243085284377726,
       0.1384281459013203, -0.2422948870663823, -0.0322448695846381,
       0.0775714938400459, -0.0062414902127983, -0.0125807519990820,
       0.0033357252854738)
DB5_HI = tuple((-1) ** k * DB5[len(DB5) - 1 - k] for k in range(len(DB5)))
F64 = torch.float64


def _tf32(x):
    """float64 values (a tensor or a number) rounded to TF32."""
    t = torch.as_tensor(x, dtype=F64)
    return round_tf32(t.to(torch.float32)).to(F64)


def _products(x: torch.Tensor, w: float, tf32: bool) -> torch.Tensor:
    if tf32:
        return _tf32(x) * _tf32(w)
    return x * w


def _down(x: torch.Tensor, f, axis: int, tf32: bool) -> torch.Tensor:
    n = x.shape[axis]
    even = torch.arange(0, n, 2, device=x.device)
    return sum(_products(x.index_select(axis, (even + j) % n), fj, tf32)
               for j, fj in enumerate(f))


def _up(a: torch.Tensor, f, axis: int, tf32: bool) -> torch.Tensor:
    n = 2 * a.shape[axis]
    am = a.movedim(axis, 0)
    up = am.new_zeros((n,) + tuple(am.shape[1:]))
    up[::2] = am
    up = up.movedim(0, axis)
    m = torch.arange(n, device=a.device)
    return sum(_products(up.index_select(axis, (m - j) % n), fj, tf32)
               for j, fj in enumerate(f))


def _color(x: torch.Tensor, m, tf32: bool) -> torch.Tensor:
    """3x3 matrix rows over the last (channel) axis."""
    c = [x[..., i] for i in range(3)]
    return torch.stack([sum(_products(c[i], m[d][i], tf32) for i in range(3))
                        for d in range(3)], dim=-1)


def padding(h: int, w: int, levels: int):
    """(padded H, padded W, top pad, left pad)."""
    m = 1 << levels
    hp, wp = -(-h // m) * m, -(-w // m) * m
    return hp, wp, (hp - h) // 2, (wp - w) // 2


def band_shapes(h: int, w: int, levels: int) -> list:
    """One frame's (h, w, 3) subband shapes, coarsest first: LL, then LH,
    HL, HH of each level."""
    hp, wp, _, _ = padding(h, w, levels)
    shapes = [(hp >> levels, wp >> levels, 3)]
    for lvl in range(levels, 0, -1):
        shapes += [(hp >> lvl, wp >> lvl, 3)] * 3
    return shapes


def group_sizes(h: int, w: int, levels: int) -> list:
    """Symbols of one frame a group: LL twice (its two planes), then each
    detail band."""
    n = [a * b * c for a, b, c in band_shapes(h, w, levels)]
    return [n[0]] + n


def grid_dims(sizes) -> tuple:
    """(sg, L) of the lane grid of one frame's group sizes."""
    target = max(8, sum(sizes) // 512 // len(sizes))
    sg = 1 << (target.bit_length() - 1)
    l = -(-max(sizes) // sg)
    return sg, -(-l // 4) * 4


def forward(pixels: torch.Tensor, qss: int, levels: int,
            tf32: bool = False) -> list:
    """u8 frames (N, H, W, 3) -> the groups' byte planes, each (N, n)
    uint8."""
    n, h, w, _ = pixels.shape
    hp, wp, top, left = padding(h, w, levels)
    x = torch.zeros((n, hp, wp, 3), dtype=F64, device=pixels.device)
    x[:, top:top + h, left:left + w] = pixels.to(F64)
    cur = _color(x - OFFSET, YCOCG_FWD, tf32)
    details = []
    for _ in range(levels):
        lo, hi = (_down(cur, f, 1, tf32) for f in (DB5, DB5_HI))
        cur = _down(lo, DB5, 2, tf32)
        details.append((_down(lo, DB5_HI, 2, tf32), _down(hi, DB5, 2, tf32),
                        _down(hi, DB5_HI, 2, tf32)))
    bands = [cur] + [b for d in details[::-1] for b in d]
    ks = [torch.trunc(b / qss).to(torch.int64) + OFFSET for b in bands]
    v = ks[0] & 0xFFFF
    planes = [v >> 8, v & 0xFF] + [k & 0xFF for k in ks[1:]]
    return [p.to(torch.uint8).reshape(n, -1) for p in planes]


def grid(planes: list, sg: int, l: int) -> torch.Tensor:
    """The groups' (N, n) planes -> the (G * sg * N, L) lane grid."""
    blocks = []
    for p in planes:
        pad = p.new_full((p.shape[0], sg * l - p.shape[1]), OFFSET)
        blocks.append(torch.cat([p, pad], dim=1).reshape(-1, l))
    return torch.cat(blocks)


def forward_grid(pixels: torch.Tensor, qss: int, levels: int,
                 tf32: bool = False) -> torch.Tensor:
    """u8 frames (N, H, W, 3) -> their (G * sg * N, L) u8 lane grid."""
    _, h, w, _ = pixels.shape
    sg, l = grid_dims(group_sizes(h, w, levels))
    return grid(forward(pixels, qss, levels, tf32), sg, l)


def planes_of(lanes: torch.Tensor, sizes, frames: int) -> list:
    """Inverse of `grid`: the groups' (N, n) planes."""
    blocks = lanes.reshape(len(sizes), frames, -1)
    return [b[:, :n] for b, n in zip(blocks, sizes)]


def indexes(planes: list) -> list:
    """Byte planes -> each band's stored value: LL's 16-bit (k + 128) &
    0xFFFF, a detail band's 8-bit (k + 128) & 0xFF, as int64."""
    p = [x.to(torch.int64) for x in planes]
    return [(p[0] << 8) | p[1]] + p[2:]


def inverse(planes: list, shape, frames: int, qss: int, levels: int,
            tf32: bool = False) -> torch.Tensor:
    """The groups' (N, n) planes -> u8 frames (N, H, W, 3) of one
    frame's (H, W, 3) `shape`."""
    h, w = shape[0], shape[1]
    v = indexes(planes)
    ks = [torch.where(v[0] >= 32768, v[0] - 65536, v[0]) - OFFSET]
    ks += [b - OFFSET for b in v[1:]]
    bands = [(k.to(F64) * qss).reshape((frames,) + s)
             for k, s in zip(ks, band_shapes(h, w, levels))]
    cur = bands[0]
    for lvl in range(levels):
        lh, hl, hh = bands[1 + 3 * lvl: 4 + 3 * lvl]
        lo = _up(cur, DB5, 2, tf32) + _up(lh, DB5_HI, 2, tf32)
        hi = _up(hl, DB5, 2, tf32) + _up(hh, DB5_HI, 2, tf32)
        cur = _up(lo, DB5, 1, tf32) + _up(hi, DB5_HI, 1, tf32)
    _, _, top, left = padding(h, w, levels)
    y = _color(cur, YCOCG_INV, tf32)[:, top:top + h, left:left + w] + OFFSET
    return torch.clamp(torch.round(y), 0, 255).to(torch.uint8)


def inverse_grid(lanes: torch.Tensor, shape, frames: int, qss: int,
                 levels: int, tf32: bool = False) -> torch.Tensor:
    """A (G * sg * N, L) lane grid -> u8 frames (N, H, W, 3)."""
    sizes = group_sizes(shape[0], shape[1], levels)
    return inverse(planes_of(lanes, sizes, frames), shape, frames, qss,
                   levels, tf32)


def index_diffs(lanes: torch.Tensor, ref: torch.Tensor, shape,
                frames: int, levels: int) -> tuple:
    """(share of the real symbols that differ, entries whose circular
    distance from the reference's is over 1) of a lane grid against the
    reference's: the distance is taken on each band's stored value, mod
    2^16 for LL and mod 2^8 for a detail band."""
    if lanes.shape != ref.shape:
        return 1.0, lanes.numel() + ref.numel()
    sizes = group_sizes(shape[0], shape[1], levels)
    a = planes_of(lanes, sizes, frames)
    b = planes_of(ref, sizes, frames)
    differ = sum(int((x != y).sum()) for x, y in zip(a, b))
    over1 = 0
    for x, y, mod in zip(indexes(a), indexes(b),
                         [1 << 16] + [1 << 8] * (len(sizes) - 2)):
        d = (x - y) % mod
        over1 += int((torch.minimum(d, mod - d) > 1).sum())
    return differ / (frames * sum(sizes)), over1
