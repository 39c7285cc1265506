"""Plain reference of the `cgrans` context coder: static 15-bit tables per
(lane group, context class), interleaved rANS with 32-bit states and
16-bit words, over a lane grid (S, L) whose lane s is in group
s // (S / G).

The class of a symbol is taken from the symbol before it in its lane:
with 4 classes, the number of the thresholds 1, 2, 5 that |prev - 128|
reaches; a lane's first symbol takes the class of 128, which is 0.
`tables` works the static tables out from a grid as the configuration
trains them: a histogram per (group, class), quantized as the `grans`
tables are (`rans.quantize_freqs`).  `decode` decodes a stream step by
step, every lane at once, each lane's table row chosen by the class of
the symbol it decoded one step before, and counts every way in which the
stream is not the encoding of what it decodes to (as `rans.decode`).

Plain NumPy and torch only; no import of the code under test.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.rans import K_PROB, MASK, RANS_L, quantize_freqs

BOUNDS = {4: (1, 2, 5)}


def classes(prev: torch.Tensor, n_ctx: int) -> torch.Tensor:
    """The context class of each previous symbol, int64."""
    d = (prev.to(torch.int64) - 128).abs()
    return sum((d >= b).to(torch.int64) for b in BOUNDS[n_ctx])


def _groups(s_streams: int, g: int, device) -> torch.Tensor:
    return torch.arange(s_streams, device=device) // (s_streams // g)


def tables(lanes: torch.Tensor, g: int, n_ctx: int) -> np.ndarray:
    """(S, L) uint8 lanes -> (G, n_ctx, 256) int64 frequencies."""
    x = lanes.to(torch.int64)
    prev = torch.cat([torch.full_like(x[:, :1], 128), x[:, :-1]], dim=1)
    row = _groups(x.shape[0], g, x.device)[:, None] * n_ctx + classes(
        prev, n_ctx)
    counts = torch.bincount((row * 256 + x).reshape(-1),
                            minlength=g * n_ctx * 256)
    return np.stack([quantize_freqs(c) for c in counts.reshape(
        g * n_ctx, 256).cpu().numpy()]).reshape(g, n_ctx, 256)


def cums_of(freqs: np.ndarray) -> np.ndarray:
    """(..., 256) frequencies -> each symbol's slot start."""
    freqs = np.asarray(freqs, np.int64)
    return np.cumsum(freqs, -1) - freqs


def decode(words: torch.Tensor, states: torch.Tensor, freqs: np.ndarray,
           l: int, counts=None):
    """Decode L steps of S lanes.  words: (n,) int64 values < 2^16;
    states (S,) int64; freqs (G, n_ctx, 256).  Returns (lanes (S, L)
    uint8, errors): errors counts lanes not ending at 2^16, |words used -
    n|, table rows whose frequencies do not sum to 2^15 and, if counts
    (L,) are given, steps whose word count differs from them."""
    dev = states.device
    s_streams = states.numel()
    freqs = np.asarray(freqs, np.int64)
    g, n_ctx = freqs.shape[:2]
    rows = freqs.reshape(g * n_ctx, 256)
    errors = int((rows.sum(1) != 1 << K_PROB).sum())
    slot2sym = np.zeros((g * n_ctx, 1 << K_PROB), np.int64)
    for r in range(g * n_ctx):
        if rows[r].sum() == 1 << K_PROB:
            slot2sym[r] = np.repeat(np.arange(256), rows[r])
    slot2sym = torch.from_numpy(slot2sym.reshape(-1)).to(dev)
    f_tab = torch.from_numpy(rows.reshape(-1)).to(dev)
    c_tab = torch.from_numpy(cums_of(rows).reshape(-1)).to(dev)
    grp = _groups(s_streams, g, dev)
    n = words.numel()
    padded = torch.cat([words.to(dev, torch.int64),
                        torch.zeros(1, dtype=torch.int64, device=dev)])
    x = states.to(dev, torch.int64).clone()
    prev = torch.full((s_streams,), 128, dtype=torch.int64, device=dev)
    out = torch.empty((s_streams, l), dtype=torch.uint8, device=dev)
    used = torch.empty(l, dtype=torch.int64, device=dev)
    ptr = torch.zeros((), dtype=torch.int64, device=dev)
    for t in range(l):
        row = grp * n_ctx + classes(prev, n_ctx)
        slot = x & MASK
        v = slot2sym[(row << K_PROB) + slot]
        i = row * 256 + v
        x = f_tab[i] * (x >> K_PROB) + slot - c_tab[i]
        renorm = x < RANS_L
        pos = (ptr + torch.cumsum(renorm, 0) - 1).clamp(0, n)
        x = torch.where(renorm, (x << 16) | padded[pos], x)
        used[t] = renorm.sum()
        ptr = ptr + used[t]
        out[:, t] = v.to(torch.uint8)
        prev = v
    errors += int((x != RANS_L).sum()) + abs(int(ptr) - n)
    if counts is not None:
        errors += int((used != counts.to(dev, torch.int64)).sum())
    return out, errors
