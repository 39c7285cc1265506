"""Plain reference of the lane layout the `grans` lane-grid stream uses.

The stream codes the index planes of a clip as S interleaved rANS lanes
in 64 groups, one group per DCT coefficient (gy, gx).  Inside each
32-row, cw-column tile of the planes, lane-major order runs over
(frame, channel, tile row, block row, tile column, block column).
These are the format's laws, written out here from scratch: the lane
count, the tile width and the order of the symbols in the lanes.
"""

from __future__ import annotations

import math

import torch

ROWS = 32      # tile rows
CW_MAX = 512   # widest tile


def chunk_w(w: int, b: int = 8) -> int:
    """Tile width of a W-wide plane: the largest power-of-two divisor
    chunk of W up to 512, at least b."""
    cw = min(w, CW_MAX)
    while w % cw:
        cw //= 2
    return max(cw, b)


def pick_streams(n: int, requested: int = 65536) -> int:
    """Lane count for n symbols: the largest power of two with about 512
    symbols a lane or more, at most `requested`, at least 8."""
    target = min(requested, max(8, n // 512))
    return 1 << max(3, int(math.floor(math.log2(target))))


def _dims(shape, b: int):
    n, c, h, w = shape
    cw = chunk_w(w, b)
    if h % ROWS or w % cw:
        raise ValueError(f"planes {tuple(shape)} do not tile")
    return n, c, h // ROWS, ROWS // b, w // cw, cw // b


def lanes_of(planes: torch.Tensor, s_streams: int, b: int = 8
             ) -> torch.Tensor:
    """(N, C, H, W) block-layout indexes -> (L, S) lanes, lane s holding
    coefficient group s // (S / b^2)."""
    n, c, jt, br, kt, bc = _dims(planes.shape, b)
    x = planes.reshape(n, c, jt, br, b, kt, bc, b)        # gy at 4, gx at 7
    x = x.permute(4, 7, 0, 1, 2, 3, 5, 6)
    return x.reshape(s_streams, -1).t()


def planes_of(lanes: torch.Tensor, shape, b: int = 8) -> torch.Tensor:
    """Inverse of `lanes_of`: (L, S) lanes -> (N, C, H, W) block layout."""
    n, c, jt, br, kt, bc = _dims(shape, b)
    x = lanes.t().reshape(b, b, n, c, jt, br, kt, bc)
    return x.permute(2, 3, 4, 5, 0, 6, 7, 1).reshape(shape)
