"""Plain reference of the `grans` entropy coder: static 15-bit tables per
lane group, interleaved rANS with 32-bit states and 16-bit words.

`tables` works the static tables out from lanes, as the configuration
trains them: a histogram per group, quantized to frequencies >= 1 that
sum to 2^15 (every symbol present).  `decode` decodes a stream step by
step, every lane at once: at step t each lane reads its symbol from its
state, and the lanes whose state falls under 2^16 read the next words of
the one word stream in lane order.  It counts every way in which the
stream is not the encoding of what it decodes to: a lane that does not
end in the initial state 2^16, words left over or missing, and, where
the stream carries them, per-step word counts or per-lane emit flags
that differ from the renormalizations.

Plain NumPy and torch only; no import of the code under test.
"""

from __future__ import annotations

import numpy as np
import torch

K_PROB = 15
RANS_L = 1 << 16
MASK = (1 << K_PROB) - 1


def quantize_freqs(counts: np.ndarray, k: int = K_PROB) -> np.ndarray:
    """Counts of 256 symbols -> integer frequencies >= 1 summing to 2^k:
    each rounded from its share, then the sum repaired one unit at a
    time over the symbols in order of falling frequency (stable)."""
    total = 1 << k
    counts = counts.astype(np.float64)
    if counts.sum() == 0:
        counts[:] = 1.0
    f = np.maximum(1, np.round(counts / counts.sum() * total)).astype(
        np.int64)
    diff = total - int(f.sum())
    order = np.argsort(-f, kind="stable")
    i = 0
    while diff != 0:
        s = order[i % f.size]
        step = 1 if diff > 0 else -1
        if f[s] + step >= 1:
            f[s] += step
            diff -= step
        i += 1
    return f


def tables(lanes: torch.Tensor, g: int = 64) -> np.ndarray:
    """(L, S) uint8 lanes -> (G, 256) int64 frequencies, lane s in group
    s // (S / G)."""
    x = lanes.t().reshape(g, -1).to(torch.int64)
    x = x + 256 * torch.arange(g, device=x.device)[:, None]
    counts = torch.bincount(x.reshape(-1), minlength=256 * g).reshape(g, 256)
    return np.stack([quantize_freqs(c) for c in counts.cpu().numpy()])


def cums_of(freqs: np.ndarray) -> np.ndarray:
    """(G, 256) frequencies -> (G, 256) cumulative frequencies (each
    symbol's slot start)."""
    freqs = np.asarray(freqs, np.int64)
    return np.concatenate([np.zeros((freqs.shape[0], 1), np.int64),
                           np.cumsum(freqs, 1)[:, :-1]], 1)


def compact_raw(raw: torch.Tensor):
    """A raw (L, S) int32 grid of (emit << 16) | low16 per decode step ->
    (words in decode order (t, then s), emit flags (L, S) bool)."""
    flags = (raw >> 16) != 0
    return torch.masked_select(raw & 0xFFFF, flags).to(torch.int64), flags


def decode(words: torch.Tensor, states: torch.Tensor, freqs: np.ndarray,
           l: int, counts=None, flags=None):
    """Decode L steps of S lanes.  words: (n,) int64 values < 2^16;
    states (S,) int64; freqs (G, 256).  Returns (lanes (L, S) uint8,
    errors) where errors counts lanes not ending at 2^16, |words used -
    n|, groups whose frequencies do not sum to 2^15, and, if given, steps
    whose word count differs from counts (L,) and lane-steps whose
    renormalization differs from flags (L, S)."""
    dev = states.device
    s_streams = states.numel()
    freqs = np.asarray(freqs, np.int64)
    g = freqs.shape[0]
    errors = int((freqs.sum(1) != 1 << K_PROB).sum())
    cums = cums_of(freqs)
    slot2sym = np.zeros((g, 1 << K_PROB), np.int64)
    for grp in range(g):
        if freqs[grp].sum() == 1 << K_PROB:
            slot2sym[grp] = np.repeat(np.arange(256), freqs[grp])
    slot2sym = torch.from_numpy(slot2sym.reshape(-1)).to(dev)
    f_tab = torch.from_numpy(freqs.reshape(-1)).to(dev)
    c_tab = torch.from_numpy(cums.reshape(-1)).to(dev)
    grp = torch.arange(s_streams, device=dev) // (s_streams // g)
    slot_base, sym_base = grp << K_PROB, grp * 256
    n = words.numel()
    padded = torch.cat([words.to(dev, torch.int64),
                        torch.zeros(1, dtype=torch.int64, device=dev)])
    x = states.to(dev, torch.int64).clone()
    out = torch.empty((l, s_streams), dtype=torch.uint8, device=dev)
    used = torch.empty(l, dtype=torch.int64, device=dev)
    flag_errors = torch.zeros((), dtype=torch.int64, device=dev)
    ptr = torch.zeros((), dtype=torch.int64, device=dev)
    for t in range(l):
        slot = x & MASK
        v = slot2sym[slot_base + slot]
        i = sym_base + v
        x = f_tab[i] * (x >> K_PROB) + slot - c_tab[i]
        renorm = x < RANS_L
        pos = (ptr + torch.cumsum(renorm, 0) - 1).clamp(0, n)
        x = torch.where(renorm, (x << 16) | padded[pos], x)
        used[t] = renorm.sum()
        ptr = ptr + used[t]
        out[t] = v.to(torch.uint8)
        if flags is not None:
            flag_errors += (renorm != flags[t]).sum()
    errors += int((x != RANS_L).sum()) + abs(int(ptr) - n)
    errors += int(flag_errors)
    if counts is not None:
        errors += int((used != counts.to(dev, torch.int64)).sum())
    return out, errors
