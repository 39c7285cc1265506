"""The work of the DWT intra cell's two layers, counted from its shapes,
for the roofline shares (`core/work.py`'s peaks and `least_s`).

- The wavelet layer, pixels to symbols or back: u8 pixels read or
  written once, the real symbols of the lane grid (not its padding)
  written or read once, and float32 operations a pixel (a multiply-add
  counts 2): 5 for the colour row, 2 for the quantizer, and the bank's
  published taps, each level's two passes giving as many outputs as the
  level's input has elements.  Synthesis counts the same taps: the zeros
  of the upsampled bands are not counted.
- The entropy layer's context coder, bytes only (the rANS state chain's
  integer work has no peak of its own): the real symbols, the 16-bit
  words, the 32-bit final states and per-step counts, the (G, n_ctx, 256)
  tables of 32-bit entries.
"""

from __future__ import annotations

from portbench.core.work import least_s


def bank_ops_per_elem(taps: int, levels: int) -> float:
    """float32 operations a pixel of a separable 2D bank of `taps`-tap
    filters over `levels` levels: 2 passes a level, 2 * taps operations
    an output, level k's input 4^-k of the frame's elements."""
    return sum(2 * 2 * taps / 4 ** k for k in range(levels))


def wavelet_ops_per_elem(taps: int, levels: int) -> float:
    return bank_ops_per_elem(taps, levels) + 5 + 2


def wavelet_s(work: dict) -> float:
    ops = work["elements"] * wavelet_ops_per_elem(work["wavelet_taps"],
                                                  work["levels"])
    return least_s(work["pixel_bytes"] + work["symbols"], ops)


def ctx_entropy_s(work: dict) -> float:
    n_bytes = (work["symbols"] + 2 * work["n_words"] + 4 * work["s_streams"]
               + 4 * work["l_steps"] + 4 * work["groups"] * work["n_ctx"]
               * 256)
    return least_s(n_bytes)
