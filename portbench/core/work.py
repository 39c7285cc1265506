"""The yardstick of the roofline shares: the card's peaks and the work
each layer's job needs, counted from the cell's shapes.

Each input byte is read once and each output byte written once; the
least time of a job is the larger of its bytes over the HBM bandwidth
and its float32 operations over the float32 peak (NVIDIA H100 SXM data
sheet: 3.35 TB/s, 67 TFLOP/s outside the tensor cores).  The work is the
job's and not that of the kernels that happen to do it, so fusing,
splitting or renaming kernels inside a span leaves it as it is.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def least_s(n_bytes: float, ops: float = 0.0) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def dct_ops_per_elem(b: int, color: bool = True) -> int:
    """Operations per element of the colour + DCT + quantizer (a
    multiply-add counts 2): two b-term passes, the quantizer's multiply
    and add, the 3-term colour row."""
    return 4 * b + 2 + 5 * int(color)


def transform_s(symbols: int, b: int) -> float:
    """Pixels to indexes or back, both uint8, one element each."""
    return least_s(2 * symbols, symbols * dct_ops_per_elem(b))


def entropy_s(work: dict) -> float:
    """Symbols to the stream or back (bytes only: the rANS state chain's
    integer work has no peak of its own): the uint8 symbols, the 16-bit
    words, the 32-bit final states, the 32-bit per-step counts where the
    stream carries them, and the (G, 256) tables of 32-bit entries."""
    n_bytes = (work["symbols"] + 2 * work["n_words"] + 4 * work["s_streams"]
               + 4 * work["l_steps"] * int(work["wire"])
               + 4 * work["groups"] * 256)
    return least_s(n_bytes)


def sad_s(work: dict) -> float:
    """Full search over every P frame: 3 operations a term (difference,
    absolute value, add), the two float32 lumas read once, the int32 mvs
    written once."""
    blocks = work["p_frames"] * work["blocks"]
    terms = blocks * (2 * work["search"] + 1) ** 2 * work["block"] ** 2
    n_bytes = 2 * 4 * work["p_frames"] * work["pixels"] + 8 * blocks
    return least_s(n_bytes, 3 * terms)
