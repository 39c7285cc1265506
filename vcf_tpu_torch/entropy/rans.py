"""Interleaved rANS (port of vcf_tpu/entropy/rans.py: `rans`, `grans`,
`cgrans` and `srans`).

S streams share ONE word stream: the decoder's renormalization schedule
is state-driven, so at each step the renormalizing streams consume the
next words in stream order.  The encoder walks symbols newest first
(standard rANS) and records, per decode step, each lane's low 16 bits
and whether it emitted them (the raw grid); one compaction then packs
the emitted words in decoder order.  Formats and state law are
vcf_tpu's, byte for byte: 15-bit probabilities, 32-bit states, 16-bit
words.

The three stages are the kernels of `vcf_tpu_torch.ops.cuda`: K1 encode
to the raw grid, K2 compaction, K3 decode; the order-1 context coder
(`cgrans`) runs the context modes of K1 and K3 (`ops.cuda.rans_ctx`)
with K2 between them.  On a CUDA device every encode and decode launches
them; on the CPU their plain torch versions run.  The NumPy reference
implementations (`np_*`) define the format.

`grid_lanes*` / `grid_unlanes*` lay out the index planes of the
subband-grid tile layout (the `grid_layout` modes of B1-B4) as lanes
with plain reshapes: the device-resident lane-grid path, whose raw
(L, S) grid the routing-free grid decode reads directly.  They run in a
`vcf.rans.layout` span, and the reshapes that copy count their bytes in
`layout_bytes` (`utils.profiling`).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from vcf_tpu_torch.entropy.base import EntropyCodec
from vcf_tpu_torch.ops.cuda.rans_ctx import (CTX_BOUNDS, N_CTX, class_lut,
                                             rans_decode_ctx, rans_encode_ctx)
from vcf_tpu_torch.ops.cuda.rans_decode import rans_decode_grouped
from vcf_tpu_torch.ops.cuda.rans_encode import (K_PROB, MASK, RANS_L,
                                                _SHIFT_EMIT, rans_compact,
                                                rans_encode_grouped)
from vcf_tpu_torch.utils import profiling

__all__ = ["K_PROB", "RANS_L", "MASK", "quantize_freqs", "np_encode_grouped",
           "np_decode_grouped", "subband_lanes", "subband_unlanes",
           "grid_lanes", "grid_lanes_lmajor", "grid_unlanes",
           "grid_unlanes_lmajor", "group_histograms", "freqs_from_counts",
           "encode_lanes_device", "N_CTX", "CTX_BOUNDS",
           "subband_lanes_ctx", "subband_unlanes_ctx", "ctx_class",
           "ctx_class_n", "np_encode_ctx", "ctx_group_histograms",
           "ctx_cums", "ctx_freqs_from_counts", "RANSCodec", "GroupedRANSCodec",
           "CtxRANSCodec", "pack_flags", "unpack_flags", "SparseRANSCodec"]


# ---------------------------------------------------------------------------
# Probability quantization
# ---------------------------------------------------------------------------

def quantize_freqs(counts: np.ndarray, k: int = K_PROB,
                   min_all: bool = False) -> np.ndarray:
    """Quantize counts to integer freqs >= 1 (for present symbols) that
    sum to exactly 2^k.  Deterministic.

    min_all=True gives EVERY symbol freq >= 1 even when its count is 0 —
    required whenever the model is trained on a sample (e.g. one frame
    of a batch) rather than the exact data it will code: a zero-freq
    symbol encountered at encode time corrupts the stream silently.
    Rate cost: <= 256 parts in 2^k (~0.1% at k=12)."""
    total = 1 << k
    counts = counts.astype(np.float64)
    n_syms = counts.shape[0]
    if counts.sum() == 0:
        # all-zero counts (e.g. empty training sample): intentional
        # uniform model rather than a 0/0 division below
        counts[:] = 1.0
    present = np.ones(n_syms, bool) if min_all else counts > 0
    f = np.zeros(n_syms, np.int64)
    scaled = counts / counts.sum() * total
    f[present] = np.maximum(1, np.round(scaled[present]).astype(np.int64))
    # repair the sum by walking the largest entries (deterministic order)
    diff = total - int(f.sum())
    order = np.argsort(-f, kind="stable")
    i = 0
    while diff != 0:
        s = order[i % n_syms]
        if f[s] > 1 or diff > 0:
            step = 1 if diff > 0 else -1
            if f[s] + step >= 1:
                f[s] += step
                diff -= step
        i += 1
    return f.astype(np.uint32)


def _cums(freqs: np.ndarray) -> np.ndarray:
    return np.concatenate(([0], np.cumsum(freqs)))[:256].astype(np.uint32)


# ---------------------------------------------------------------------------
# NumPy reference: grouped interleaved rANS (defines the format)
# ---------------------------------------------------------------------------

def np_encode_grouped(syms: np.ndarray, freqs_g: np.ndarray):
    """Grouped-lane NumPy reference: lane s uses table s // (S // G)."""
    s_streams, l = syms.shape
    g = freqs_g.shape[0]
    sg = s_streams // g
    cums = [np.concatenate(([0], np.cumsum(fq)))[:256].astype(np.uint64)
            for fq in freqs_g]
    f64 = freqs_g.astype(np.uint64)
    x = np.full(s_streams, RANS_L, np.uint64)
    emitted: List[int] = []
    x_max_mul = (RANS_L << 16) >> K_PROB
    for t in range(l - 1, -1, -1):
        for s in range(s_streams - 1, -1, -1):
            grp = s // sg
            v = int(syms[s, t])
            f = int(f64[grp, v])
            if x[s] >= f * x_max_mul:
                emitted.append(int(x[s] & 0xFFFF))
                x[s] >>= 16
            x[s] = ((x[s] // f) << K_PROB) + (x[s] % f) + int(cums[grp][v])
    return np.array(emitted[::-1], np.uint16), x.astype(np.uint32)


def np_decode_grouped(words, states, freqs_g, s_streams: int, l: int):
    g = freqs_g.shape[0]
    sg = s_streams // g
    cums = [np.concatenate(([0], np.cumsum(fq)))[:256].astype(np.int64)
            for fq in freqs_g]
    slot2sym = np.zeros((g, 1 << K_PROB), np.int64)
    for grp in range(g):
        for v in range(256):
            slot2sym[grp, cums[grp][v]: cums[grp][v] + int(freqs_g[grp, v])] = v
    x = states.astype(np.uint64).copy()
    out = np.zeros((s_streams, l), np.uint8)
    ptr = 0
    for t in range(l):
        for s in range(s_streams):
            grp = s // sg
            slot = int(x[s]) & MASK
            v = int(slot2sym[grp, slot])
            out[s, t] = v
            x[s] = int(freqs_g[grp, v]) * (int(x[s]) >> K_PROB) + slot \
                - int(cums[grp][v])
            if x[s] < RANS_L:
                x[s] = (x[s] << 16) | int(words[ptr])
                ptr += 1
    return out


# ---------------------------------------------------------------------------
# Lane layout and per-group models
# ---------------------------------------------------------------------------

def subband_lanes(planes: torch.Tensor, b: int, s_streams: int) -> torch.Tensor:
    """(N, H, W, C) planes in subband layout -> (S, L) lane matrix where
    each contiguous block of S/b^2 lanes holds exactly one subband's
    symbols (so the grouped coder with G = b^2 gives every subband its
    own model).  Pure reshapes/permutes."""
    n, h, w, c = planes.shape
    g = b * b
    sg = s_streams // g
    sb = planes.reshape(n, b, h // b, b, w // b, c)
    sb = sb.permute(1, 3, 0, 2, 4, 5).reshape(g, -1)        # (G, n_g)
    l = sb.shape[1] // sg
    return sb.reshape(g, l, sg).permute(0, 2, 1).reshape(g * sg, l)


def subband_unlanes(syms: torch.Tensor, b: int, shape) -> torch.Tensor:
    """Inverse of subband_lanes: (S, L) -> (N, H, W, C)."""
    n, h, w, c = shape
    g = b * b
    s_streams, l = syms.shape
    sg = s_streams // g
    sb = syms.reshape(g, sg, l).permute(0, 2, 1).reshape(g, -1)
    sb = sb.reshape(b, b, n, h // b, w // b, c)
    return sb.permute(2, 0, 3, 1, 4, 5).reshape(n, h, w, c)


def _grid_dims(shape, b: int, s_streams: int, rows: int, cw: int):
    """(g, sg, l, (j_t, br, k_t, bc)) of (N, C, H, W) grid-layout planes
    cut into s_streams lanes; raise unless the tiles and lanes fit."""
    n, c, h, w = shape
    g = b * b
    sg = s_streams // g
    j_t, k_t = h // rows, w // cw
    br, bc = rows // b, cw // b
    n_g = n * c * j_t * br * k_t * bc
    if h % rows or w % cw or sg < 1 or s_streams % g or n_g % sg:
        raise ValueError(f"grid lanes: planes {tuple(shape)} do not tile into "
                         f"({rows}, {cw}) tiles and {s_streams} lanes")
    return g, sg, n_g // sg, (j_t, br, k_t, bc)


def _grid_split(planes_grid: torch.Tensor, b: int, s_streams: int,
                rows: int, cw: int):
    """(N, C, H, W) grid-layout planes -> the (gy, gx, N, C, J, BR, K, BC)
    view every lane layout reads, with (g, sg, l)."""
    n, c = planes_grid.shape[:2]
    g, sg, l, (j_t, br, k_t, bc) = _grid_dims(planes_grid.shape, b,
                                              s_streams, rows, cw)
    x = _reshaped(planes_grid, n, c, j_t, b, br, k_t, b, bc)
    return x.permute(3, 6, 0, 1, 2, 4, 5, 7), g, sg, l


def _grid_join(xt: torch.Tensor, shape) -> torch.Tensor:
    """(gy, gx, N, C, J, BR, K, BC) -> (N, C, H, W) grid-layout planes."""
    return _reshaped(xt.permute(2, 3, 4, 0, 5, 6, 1, 7), *shape)


def _reshaped(x: torch.Tensor, *shape) -> torch.Tensor:
    """x.reshape(shape); where that copies, the bytes read and written
    count in `layout_bytes` (utils.profiling)."""
    y = x.reshape(shape)
    if y.untyped_storage().data_ptr() != x.untyped_storage().data_ptr():
        profiling.count("layout_bytes", 2 * y.nbytes)
    return y


def grid_lanes(planes_grid: torch.Tensor, b: int, s_streams: int,
               rows: int = 32, cw: int = 128) -> torch.Tensor:
    """(N, C, H, W) u8 planes in the SUBBAND-GRID tile layout of
    `fused_cdct_quantize(grid_layout=True)` (tile rows in (coeff_y,
    block_y) order, columns in (coeff_x, block_x) order) -> the (S, L)
    lane matrix with one group per coefficient (lane // (S / b^2) =
    gy * b + gx) and lane-major block order.  `cw` is the layout's tile
    width (`ops.cuda.dct_kernel._chunk_w`).  Pure reshapes/permutes."""
    with profiling.span("vcf.rans.layout"):
        xt, g, sg, l = _grid_split(planes_grid, b, s_streams, rows, cw)
        return _reshaped(xt, g * sg, l)


def grid_lanes_lmajor(planes_grid: torch.Tensor, b: int, s_streams: int,
                      rows: int = 32, cw: int = 128) -> torch.Tensor:
    """`grid_lanes` as (L, S), the layout K1 reads (pass it `.t()`):
    a strided view of the (S, L) matrix that `grid_lanes` copies out, so
    K1's wrapper makes it contiguous (a transposing copy)."""
    with profiling.span("vcf.rans.layout"):
        xt, g, sg, l = _grid_split(planes_grid, b, s_streams, rows, cw)
        return _reshaped(_reshaped(xt, g, sg, l).permute(2, 0, 1),
                         l, g * sg)


def grid_unlanes(syms: torch.Tensor, b: int, shape, rows: int = 32,
                 cw: int = 128) -> torch.Tensor:
    """Inverse of `grid_lanes`: (S, L) -> (N, C, H, W) grid-layout planes
    (the input of `fused_dequantize_cdct(grid_layout=True)`)."""
    n, c = shape[:2]
    _, _, _, (j_t, br, k_t, bc) = _grid_dims(shape, b, syms.shape[0], rows, cw)
    with profiling.span("vcf.rans.layout"):
        return _grid_join(_reshaped(syms, b, b, n, c, j_t, br, k_t, bc),
                          shape)


def grid_unlanes_lmajor(syms: torch.Tensor, b: int, shape, rows: int = 32,
                        cw: int = 128) -> torch.Tensor:
    """Inverse of `grid_lanes_lmajor`: (L, S), the `.t()` of the grid
    decode's and K3's output -> (N, C, H, W) grid-layout planes."""
    n, c = shape[:2]
    l, s_streams = syms.shape
    g, sg, _, (j_t, br, k_t, bc) = _grid_dims(shape, b, s_streams, rows, cw)
    with profiling.span("vcf.rans.layout"):
        xt = _reshaped(_reshaped(syms, l, g, sg).permute(1, 2, 0),
                       b, b, n, c, j_t, br, k_t, bc)
        return _grid_join(xt, shape)


def group_histograms(lanes: torch.Tensor, g: int) -> torch.Tensor:
    """(G*sg, L) lane matrix -> (G, 256) int64 symbol counts: one
    torch.bincount over symbol + 256 * group."""
    x = lanes.reshape(g, -1).to(torch.int64)
    x = x + 256 * torch.arange(g, device=x.device)[:, None]
    return torch.bincount(x.reshape(-1), minlength=256 * g).reshape(g, 256)


def freqs_from_counts(counts_g: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(G, 256) counts -> quantized (freqs_g, cums_g), both (G, 256)
    uint32.  Host work is 256-entry arithmetic per group (trivial)."""
    freqs_g = np.stack([
        quantize_freqs(c, min_all=True) for c in counts_g.astype(np.int64)])
    cums_g = np.stack([_cums(f) for f in freqs_g])
    return freqs_g.astype(np.uint32), cums_g


def _tables(freqs: np.ndarray, cums: np.ndarray, device: torch.device):
    return (torch.from_numpy(freqs.astype(np.int64)).to(device),
            torch.from_numpy(cums.astype(np.int64)).to(device))


def encode_lanes_device(lanes: torch.Tensor, fg: torch.Tensor,
                        cg: torch.Tensor):
    """K1 + K2 on a (S, L) lane matrix, on its device: (G, 256) int64
    tables on that device take K1's order-0 mode, (G, n_ctx, 256) its
    context mode -> (words (S * L,) uint16 whose first n_words entries are
    the stream, n_words 0-d int32, per-step counts (L,) int32, final
    states (S,) int64), nothing read back."""
    encode = rans_encode_ctx if fg.dim() == 3 else rans_encode_grouped
    raw, states = encode(lanes, fg, cg)
    words, n_words, counts = rans_compact(raw)
    return words, n_words, counts, states


def _encode_lanes(lanes: torch.Tensor, freqs: np.ndarray, cums: np.ndarray):
    """`encode_lanes_device` with numpy tables, its stream copied to the
    host -> (payload bytes, n_words, per-step counts (L,) int32 numpy,
    states (S,) uint32 numpy)."""
    words, n_words, counts, states = encode_lanes_device(
        lanes, *_tables(freqs, cums, lanes.device))
    n_words = int(n_words)
    payload = words[:n_words].cpu().numpy().astype("<u2").tobytes()
    return (payload, n_words, counts.cpu().numpy(),
            states.cpu().numpy().astype(np.uint32))


def _decode_lanes(words: np.ndarray, states: np.ndarray, freqs: np.ndarray,
                  cums: np.ndarray, l: int, counts,
                  device: torch.device) -> torch.Tensor:
    """K3 on the wire words -> (S, L) uint8 lanes on `device`; (G, 256)
    tables take K3's order-0 mode, (G, n_ctx, 256) its context mode."""
    fg, cg = _tables(freqs, cums, device)
    cnt = (torch.from_numpy(np.asarray(counts).astype(np.int64)).to(device)
           if counts is not None else None)
    decode = rans_decode_ctx if freqs.ndim == 3 else rans_decode_grouped
    return decode(
        torch.from_numpy(np.array(words, np.uint16)).to(device),
        torch.from_numpy(states.astype(np.int64)).to(device), fg, cg, l, cnt)


def _wire_words(payload: bytes, n_words: int) -> np.ndarray:
    return np.frombuffer(payload, "<u2", n_words).astype(np.uint16)


# ---------------------------------------------------------------------------
# Order-1 context modeling ("cgrans"): one table per (subband, class of
# the previous symbol in the same lane).  In the lane-major layout below
# consecutive lane positions are spatially adjacent blocks, so the
# previous symbol is the same DCT coefficient of the neighboring block.
# ---------------------------------------------------------------------------

def subband_lanes_ctx(planes: torch.Tensor, b: int,
                      s_streams: int) -> torch.Tensor:
    """(N, H, W, C) SUBBAND-layout planes -> (S, L) lanes with the same
    per-coefficient groups as subband_lanes but a LANE-MAJOR, x-adjacent
    block order: lane j of group g codes blocks f = j*L + t with f
    enumerating (channel, frame, block_row, block_col) raster, so a
    lane's previous symbol is the same coefficient of the left-adjacent
    block.  (The wrong layout still round-trips but changes the bytes.)
    Pure reshapes/permutes."""
    n, h, w, c = planes.shape
    g = b * b
    sg = s_streams // g
    sb = planes.reshape(n, b, h // b, b, w // b, c)
    sb = sb.permute(1, 3, 5, 0, 2, 4).reshape(g, -1)   # (G, f=(c,n,by,bx))
    l = sb.shape[1] // sg
    return sb.reshape(g * sg, l)


def subband_unlanes_ctx(syms: torch.Tensor, b: int, shape) -> torch.Tensor:
    """Inverse of subband_lanes_ctx: (S, L) -> (N, H, W, C)."""
    n, h, w, c = shape
    sb = syms.reshape(b, b, c, n, h // b, w // b)
    return sb.permute(3, 0, 4, 1, 5, 2).reshape(n, h, w, c)


def ctx_class_n(prev: torch.Tensor, n_ctx: int) -> torch.Tensor:
    """Previous symbol -> context class by |prev - 128|: the number of
    CTX_BOUNDS[n_ctx] thresholds it reaches (int64).  (128 is the stored
    zero index of every quantized plane in this codec family.)"""
    lut = torch.from_numpy(class_lut(n_ctx).astype(np.int64)).to(prev.device)
    return lut[prev.to(torch.int64)]


def ctx_class(prev: torch.Tensor) -> torch.Tensor:
    """{0} -> 0, {1} -> 1, {2..4} -> 2, {>=5} -> 3 (by |prev - 128|)."""
    return ctx_class_n(prev, N_CTX)


def np_encode_ctx(syms: np.ndarray, freqs_gc: np.ndarray):
    """NumPy reference of the context encode (the word order of
    np_encode_grouped; symbol 0 of a lane takes class 0)."""
    s_streams, l = syms.shape
    g, n_ctx = freqs_gc.shape[:2]
    bounds = CTX_BOUNDS[n_ctx]
    sg = s_streams // g
    cums = np.concatenate([np.zeros((g, n_ctx, 1), np.uint64),
                           np.cumsum(freqs_gc, axis=2)], axis=2)
    x = np.full(s_streams, RANS_L, np.uint64)
    emitted = []
    for t in range(l - 1, -1, -1):
        for s in range(s_streams - 1, -1, -1):
            gi = s // sg
            if t == 0:
                c = 0
            else:
                d = abs(int(syms[s, t - 1]) - 128)
                c = sum(d >= b for b in bounds)
            v = int(syms[s, t])
            f = int(freqs_gc[gi, c, v])
            if (x[s] >> _SHIFT_EMIT) >= f:
                emitted.append(int(x[s] & 0xFFFF))
                x[s] >>= 16
            x[s] = (x[s] // f << K_PROB) + (x[s] % f) + int(cums[gi, c, v])
    return np.asarray(emitted[::-1], np.uint16), x.astype(np.uint32)


def ctx_group_histograms(lanes: torch.Tensor, g: int,
                         n_ctx: int = N_CTX) -> torch.Tensor:
    """(S, L) symbols -> (G, n_ctx, 256) int64 counts of (class, symbol)
    pairs per group: one torch.bincount over
    (group * n_ctx + class) * 256 + symbol."""
    s_streams, l = lanes.shape
    x = lanes.to(torch.int64)
    prev = torch.cat([torch.full_like(x[:, :1], 128), x[:, :-1]], dim=1)
    grp = torch.arange(s_streams, device=x.device) // (s_streams // g)
    joint = (grp[:, None] * n_ctx + ctx_class_n(prev, n_ctx)) * 256 + x
    return torch.bincount(joint.reshape(-1), minlength=g * n_ctx * 256
                          ).reshape(g, n_ctx, 256)


def ctx_cums(freqs_gc: np.ndarray) -> np.ndarray:
    """(G, n_ctx, 256) freqs -> their exclusive prefix sums, uint32."""
    g, n_ctx = freqs_gc.shape[:2]
    return np.concatenate(
        [np.zeros((g, n_ctx, 1), np.uint32),
         np.cumsum(freqs_gc, axis=2)[:, :, :255].astype(np.uint32)], axis=2)


def ctx_freqs_from_counts(counts_gc: np.ndarray):
    """(G, n_ctx, 256) counts -> quantized (freqs_gc, cums_gc) uint32."""
    g, n_ctx = counts_gc.shape[:2]
    freqs = np.stack([
        np.stack([quantize_freqs(np.asarray(counts_gc[gi, c]), min_all=True)
                  for c in range(n_ctx)])
        for gi in range(g)
    ]).astype(np.uint32)
    return freqs, ctx_cums(freqs)


# ---------------------------------------------------------------------------
# Entropy-codec wrappers
# ---------------------------------------------------------------------------

class RANSCodec(EntropyCodec):
    """Interleaved static rANS with one table (the dense codec); encode
    and decode run on `device` (the kernels with G = 1 on CUDA)."""

    file_extension = ".rans"

    def __init__(self, n_streams: int = 65536, *, device):
        self.n_streams = n_streams
        self.device = torch.device(device)

    @classmethod
    def from_config(cls, config=None, *, device):
        return cls(device=device)

    @staticmethod
    def _pick_streams(n: int, requested: int) -> int:
        """Largest power of two with >= ~512 symbols per stream, capped
        at `requested` (~512 symbols/stream keeps the 4-byte final-state
        sidecar under ~0.07 bits/symbol)."""
        target = min(requested, max(8, n // 512))
        return 1 << max(3, int(np.floor(np.log2(target))))

    def _encode_u8(self, flat: np.ndarray) -> Tuple[bytes, bytes]:
        n = flat.size
        s_streams = self._pick_streams(n, self.n_streams)
        l = -(-n // s_streams)
        padded = np.pad(flat, (0, s_streams * l - n))
        counts = np.bincount(padded, minlength=256)
        freqs = quantize_freqs(counts)
        cums = _cums(freqs)
        syms = torch.from_numpy(padded.reshape(l, s_streams)).to(self.device).t()
        payload, n_words, _, states = _encode_lanes(
            syms, freqs[None], cums[None])
        side = struct.pack("<IIQI", s_streams, l, n, n_words)
        side += states.astype("<u4").tobytes()
        side += zlib.compress(freqs.astype("<u2").tobytes(), 9)
        return payload, side

    def _decode_u8(self, payload: bytes, blob: bytes) -> np.ndarray:
        s_streams, l, n, n_words = struct.unpack_from("<IIQI", blob, 0)
        off = 20
        states = np.frombuffer(blob, "<u4", s_streams, off).astype(np.uint32)
        off += 4 * s_streams
        freqs = np.frombuffer(zlib.decompress(blob[off:]), "<u2").astype(np.uint32)
        syms = _decode_lanes(_wire_words(payload, n_words), states,
                             freqs[None], _cums(freqs)[None], l, None,
                             self.device)
        flat = syms.t().reshape(-1).cpu().numpy()
        return flat[:n]

    def encode(self, arr: np.ndarray) -> Tuple[bytes, Dict[str, bytes]]:
        arr = self.check_dtype(arr)
        if arr.dtype != np.uint8:
            flat = arr.reshape(-1)
            lo, s1 = self._encode_u8((flat & 0xFF).astype(np.uint8))
            hi, s2 = self._encode_u8((flat >> 8).astype(np.uint8))
            head = struct.pack(f"<BIIB{arr.ndim}I", 1, len(lo), len(s1),
                               arr.ndim, *arr.shape)
            return lo + hi, {"rans_model": head + s1 + s2}
        payload, side = self._encode_u8(arr.reshape(-1))
        head = struct.pack(f"<BIIB{arr.ndim}I", 0, len(payload), len(side),
                           arr.ndim, *arr.shape)
        return payload, {"rans_model": head + side}

    def decode(self, payload: bytes, side: Dict[str, bytes]) -> np.ndarray:
        blob = side["rans_model"]
        mode, split, s1_len, ndim = struct.unpack_from("<BIIB", blob, 0)
        shape = struct.unpack_from(f"<{ndim}I", blob, 10)
        body = blob[10 + 4 * ndim :]
        if mode == 0:
            out = self._decode_u8(payload, body)
            return out.reshape(shape)
        lo = self._decode_u8(payload[:split], body[:s1_len])
        hi = self._decode_u8(payload[split:], body[s1_len:])
        return ((hi.astype(np.uint16) << 8) | lo).reshape(shape)


class GroupedRANSCodec(EntropyCodec):
    """Interleaved rANS with one model per DCT subband (``grans``).

    For (H, W, 3) or (N, H, W, 3) uint8 index planes in subband layout
    this codes each of the b^2 subbands with its own order-0 table.
    Shapes that do not tile into b^2 equal lane groups fall back to the
    dense single-table codec (sidecar version 0; identical API)."""

    file_extension = ".grans"

    def __init__(self, block_size: int = 8, n_streams: int = 65536, *,
                 device):
        self.b = block_size
        self.device = torch.device(device)
        self.dense = RANSCodec(n_streams, device=self.device)
        self.n_streams = n_streams
        self._frozen = None     # (freqs_g, cums_g) shared across frames

    @classmethod
    def from_config(cls, config=None, *, device):
        return cls(block_size=getattr(config, "block_size", 8), device=device)

    def _lane_count(self, size: int) -> int:
        g = self.b * self.b
        return max(g, (self.dense._pick_streams(size, self.n_streams) // g) * g)

    def freeze_tables(self, sample: np.ndarray) -> None:
        """Train the per-subband tables once and reuse them for every
        later groupable encode (min_all=True tables code any byte)."""
        planes = sample.reshape((1,) + sample.shape) if sample.ndim == 3 \
            else sample
        g = self.b * self.b
        lanes = subband_lanes(torch.from_numpy(np.ascontiguousarray(planes))
                              .to(self.device), self.b,
                              self._lane_count(sample.size))
        self._frozen = freqs_from_counts(group_histograms(lanes, g).cpu().numpy())

    def import_tables(self, freqs_g: np.ndarray, cums_g: np.ndarray) -> None:
        """Freeze tables trained elsewhere, such as vcf_tpu's
        GroupedRANSCodec._frozen after its freeze_tables."""
        g = self.b * self.b
        freqs_g = np.asarray(freqs_g).astype(np.uint32)
        cums_g = np.asarray(cums_g).astype(np.uint32)
        if freqs_g.shape != (g, 256) or cums_g.shape != (g, 256):
            raise ValueError(f"tables must be ({g}, 256), got "
                             f"{freqs_g.shape} and {cums_g.shape}")
        if np.any(freqs_g.astype(np.int64).sum(axis=1) != 1 << K_PROB):
            raise ValueError(f"every table's freqs must sum to 2^{K_PROB}")
        if not np.array_equal(cums_g, np.stack([_cums(f) for f in freqs_g])):
            raise ValueError("cums_g is not the exclusive prefix sum of freqs_g")
        self._frozen = (freqs_g, cums_g)

    def thaw_tables(self) -> None:
        self._frozen = None

    def _groupable(self, arr: np.ndarray) -> bool:
        if arr.dtype != np.uint8:
            return False
        shape = arr.shape
        if len(shape) == 3:
            shape = (1,) + shape
        if len(shape) != 4:
            return False
        n, h, w, c = shape
        if h % self.b or w % self.b:
            return False
        g = self.b * self.b
        n_g = arr.size // g
        sg = self.dense._pick_streams(arr.size, self.n_streams) // g
        return sg >= 1 and n_g % max(sg, 1) == 0

    def encode(self, arr: np.ndarray) -> Tuple[bytes, Dict[str, bytes]]:
        arr = self.check_dtype(arr)
        if not self._groupable(arr):
            payload, side = self.dense.encode(arr)
            return payload, {"grans_model": b"\x00" + side["rans_model"]}
        planes = arr.reshape((1,) + arr.shape) if arr.ndim == 3 else arr
        g = self.b * self.b
        s_streams = self._lane_count(arr.size)
        l = arr.size // s_streams
        lanes = subband_lanes(torch.from_numpy(planes).to(self.device),
                              self.b, s_streams)
        if self._frozen is not None:
            freqs_g, cums_g = self._frozen
        else:
            # per-image tables, trained from the lane matrix
            freqs_g, cums_g = freqs_from_counts(
                group_histograms(lanes, g).cpu().numpy())
        payload, n_words, counts, states = _encode_lanes(lanes, freqs_g, cums_g)
        # v2: per-decode-step renorm counts ride in the sidecar (zlib)
        counts_z = zlib.compress(counts.astype("<u4").tobytes(), 9)
        head = struct.pack(f"<BIIIB{arr.ndim}I", 2, s_streams, l, n_words,
                           arr.ndim, *arr.shape)
        side = head + struct.pack("<I", len(counts_z)) + counts_z
        side += states.astype("<u4").tobytes()
        side += zlib.compress(freqs_g.astype("<u2").tobytes(), 9)
        return payload, {"grans_model": side}

    def decode(self, payload: bytes, side: Dict[str, bytes]) -> np.ndarray:
        blob = side["grans_model"]
        version = blob[0]
        if version == 0:
            return self.dense.decode(payload, {"rans_model": blob[1:]})
        s_streams, l, n_words, ndim = struct.unpack_from("<IIIB", blob, 1)
        shape = struct.unpack_from(f"<{ndim}I", blob, 14)
        if int(l) * int(s_streams) != int(np.prod(shape)):
            raise ValueError(
                f"grans sidecar inconsistent: {s_streams} lanes x {l} "
                f"steps != prod{shape} symbols")
        off = 14 + 4 * ndim
        counts = None
        if version >= 2:
            (cz_len,) = struct.unpack_from("<I", blob, off)
            counts = np.frombuffer(
                zlib.decompress(blob[off + 4: off + 4 + cz_len]), "<u4"
            ).astype(np.int32)
            off += 4 + cz_len
        states = np.frombuffer(blob, "<u4", s_streams, off).astype(np.uint32)
        off += 4 * s_streams
        g = self.b * self.b
        freqs_g = np.frombuffer(
            zlib.decompress(blob[off:]), "<u2").astype(np.uint32).reshape(g, 256)
        cums_g = np.stack([_cums(f) for f in freqs_g])
        lanes = _decode_lanes(_wire_words(payload, n_words), states, freqs_g,
                              cums_g, l, counts, self.device)
        full = (1,) + tuple(shape) if ndim == 3 else tuple(shape)
        out = subband_unlanes(lanes, self.b, full).cpu().numpy()
        return out.reshape(shape)


class CtxRANSCodec(EntropyCodec):
    """Order-1 interleaved rANS (``cgrans``): GroupedRANSCodec's
    per-subband tables, further conditioned on the class of the previous
    symbol in the same lane (ctx_class_n, 4 or 15 classes).  The tables
    sidecar is n_ctx times larger.  Inputs that are small or cannot be
    grouped delegate to the order-0 codec (version byte 0)."""

    file_extension = ".cgrans"

    #: below this many symbols the (G, n_ctx, 256) tables sidecar
    #: outweighs the stream saving; delegate to order 0
    MIN_SYMBOLS = 4_000_000

    def __init__(self, block_size: int = 8, n_streams: int = 65536,
                 n_ctx: int = N_CTX, *, device):
        if n_ctx not in CTX_BOUNDS:
            raise ValueError(f"n_ctx must be one of {sorted(CTX_BOUNDS)}, "
                             f"got {n_ctx}")
        self.b = block_size
        self.device = torch.device(device)
        self.grouped = GroupedRANSCodec(block_size, n_streams,
                                        device=self.device)
        self.n_streams = n_streams
        self.n_ctx = n_ctx

    @classmethod
    def from_config(cls, config=None, *, device):
        return cls(block_size=getattr(config, "block_size", 8),
                   n_ctx=getattr(config, "context_classes", N_CTX),
                   device=device)

    def encode(self, arr: np.ndarray) -> Tuple[bytes, Dict[str, bytes]]:
        arr = self.check_dtype(arr)
        if not self.grouped._groupable(arr) or arr.size < self.MIN_SYMBOLS:
            payload, side = self.grouped.encode(arr)
            return payload, {"cgrans_model": b"\x00" + side["grans_model"]}
        planes = arr.reshape((1,) + arr.shape) if arr.ndim == 3 else arr
        g = self.b * self.b
        s_streams = self.grouped.dense._pick_streams(arr.size, self.n_streams)
        s_streams = max(g, (s_streams // g) * g)
        l = arr.size // s_streams
        lanes = subband_lanes_ctx(
            torch.from_numpy(np.ascontiguousarray(planes)).to(self.device),
            self.b, s_streams)
        freqs_gc, cums_gc = ctx_freqs_from_counts(
            ctx_group_histograms(lanes, g, self.n_ctx).cpu().numpy())
        payload, n_words, counts, states = _encode_lanes(lanes, freqs_gc,
                                                         cums_gc)
        counts_z = zlib.compress(counts.astype("<u4").tobytes(), 9)
        # version 2 appends the class count (v1 readers assume 4)
        head = struct.pack(f"<BBIIIB{arr.ndim}I", 2, self.n_ctx,
                           s_streams, l, n_words, arr.ndim, *arr.shape)
        side = head + struct.pack("<I", len(counts_z)) + counts_z
        side += states.astype("<u4").tobytes()
        side += zlib.compress(freqs_gc.astype("<u2").tobytes(), 9)
        return payload, {"cgrans_model": side}

    def decode(self, payload: bytes, side: Dict[str, bytes]) -> np.ndarray:
        blob = side["cgrans_model"]
        if blob[0] == 0:
            return self.grouped.decode(payload, {"grans_model": blob[1:]})
        if blob[0] >= 2:
            n_ctx, base = blob[1], 2
        else:
            n_ctx, base = 4, 1
        s_streams, l, n_words, ndim = struct.unpack_from("<IIIB", blob, base)
        shape = struct.unpack_from(f"<{ndim}I", blob, base + 13)
        if int(l) * int(s_streams) != int(np.prod(shape)):
            raise ValueError(
                f"cgrans sidecar inconsistent: {s_streams} lanes x {l} "
                f"steps != prod{shape} symbols")
        off = base + 13 + 4 * ndim
        (cz_len,) = struct.unpack_from("<I", blob, off)
        counts = np.frombuffer(
            zlib.decompress(blob[off + 4: off + 4 + cz_len]), "<u4"
        ).astype(np.int32)
        off += 4 + cz_len
        states = np.frombuffer(blob, "<u4", s_streams, off).astype(np.uint32)
        off += 4 * s_streams
        g = self.b * self.b
        freqs_gc = np.frombuffer(
            zlib.decompress(blob[off:]), "<u2").astype(np.uint32).reshape(
                g, n_ctx, 256)
        lanes = _decode_lanes(_wire_words(payload, n_words), states,
                              freqs_gc, ctx_cums(freqs_gc), l, counts,
                              self.device)
        full = (1,) + tuple(shape) if ndim == 3 else tuple(shape)
        out = subband_unlanes_ctx(lanes, self.b, full).cpu().numpy()
        return out.reshape(shape)


# ---------------------------------------------------------------------------
# Sparse rANS ("srans"): zero-flag bitplane + compacted nonzeros
# ---------------------------------------------------------------------------

#: np.packbits bit order: the first flag of a byte is its top bit
_BIT_SHIFTS = (7, 6, 5, 4, 3, 2, 1, 0)


def pack_flags(flags: torch.Tensor) -> torch.Tensor:
    """(8m,) bool -> (m,) uint8, in np.packbits bit order."""
    shifts = torch.tensor(_BIT_SHIFTS, dtype=torch.int32, device=flags.device)
    bits = flags.reshape(-1, 8).to(torch.int32) << shifts
    return bits.sum(dim=1, dtype=torch.int32).to(torch.uint8)


def unpack_flags(packed: torch.Tensor) -> torch.Tensor:
    """(m,) uint8 -> (8m,) bool, the inverse of pack_flags."""
    shifts = torch.tensor(_BIT_SHIFTS, dtype=torch.int32, device=packed.device)
    return ((packed.to(torch.int32)[:, None] >> shifts) & 1).reshape(-1).bool()


class SparseRANSCodec(EntropyCodec):
    """Sparse interleaved rANS (``srans``) for quantized planes where one
    symbol dominates.  The plane is split into (a) a flag bitplane, 8
    flags a byte, flagging every symbol that is not the most frequent
    one, and (b) the flagged symbols in order (`masked_select`), padded
    with the most frequent of them up to a bucket of the plane size
    (`_bucket`: vcf_tpu's static shapes, kept for its bytes).  Both byte
    streams go through the dense codec's lane path: on CUDA K1, K2 and
    K3 with one table each.  Decode scatters the prefix back to the
    flagged positions by the flags' running count.  The format is
    vcf_tpu's byte for byte (`srans_model`: struct "<QQIBBIIII", the
    states, a reserved word and zlib level 9 of both tables)."""

    file_extension = ".srans"

    def __init__(self, n_streams: int = 65536, *, device):
        self.n_streams = n_streams
        self.device = torch.device(device)

    @classmethod
    def from_config(cls, config=None, *, device):
        return cls(device=device)

    @staticmethod
    def _bucket(n_nz: int, n: int, multiple: int) -> int:
        """Round n_nz up to a multiple of max(n/32, 4096, `multiple`)
        (itself rounded up to a multiple of `multiple`)."""
        step = max(4096, n // 32, multiple)
        step = -(-step // multiple) * multiple
        return max(step, -(-n_nz // step) * step)

    @staticmethod
    def _freqs(counts: np.ndarray):
        f = quantize_freqs(counts, min_all=True)
        return f.astype(np.uint32), _cums(f)

    def _encode_u8(self, flat: np.ndarray) -> Tuple[bytes, bytes]:
        n = flat.size
        pick = RANSCodec._pick_streams
        s_flags = pick(max(n // 8, 1), self.n_streams)
        pad = (-n) % (8 * s_flags)
        n8 = n + pad
        fj = torch.zeros(n8, dtype=torch.uint8, device=self.device)
        fj[:n] = torch.from_numpy(flat).to(self.device)
        counts = torch.bincount(fj.to(torch.int64), minlength=256).cpu(
            ).numpy().astype(np.int64)
        zero_sym = int(np.argmax(counts))
        counts[zero_sym] -= pad                 # as vcf_tpu counts the padding
        n_nz = int(n - counts[zero_sym])        # == the flags set in fj
        nz_counts = counts.copy()
        nz_counts[zero_sym] = 0
        fill = int(np.argmax(nz_counts)) if n_nz else (zero_sym + 1) % 256
        # s_nz | 8*s_flags (powers of two) => s_nz | n8, so cap <= n8
        s_nz = min(pick(max(n_nz, 1), self.n_streams), 8 * s_flags)
        cap = min(self._bucket(max(n_nz, 1), n8, s_nz), n8)
        nz_counts[fill] += cap - n_nz           # the padding fill symbols
        nz_f, nz_c = self._freqs(nz_counts)
        flags = fj != zero_sym
        flag_bytes = pack_flags(flags)
        flag_f, flag_c = self._freqs(torch.bincount(
            flag_bytes.to(torch.int64), minlength=256).cpu().numpy())
        nz = torch.full((cap,), fill, dtype=torch.uint8, device=self.device)
        nz[:n_nz] = torch.masked_select(fj, flags)
        p_flags, fnw, _, fst = _encode_lanes(
            flag_bytes.reshape(-1, s_flags).t(), flag_f[None], flag_c[None])
        p_nz, znw, _, zst = _encode_lanes(
            nz.reshape(-1, s_nz).t(), nz_f[None], nz_c[None])
        side = struct.pack("<QQIBBIIII", n, n_nz, cap, zero_sym, fill,
                           s_flags, s_nz, fnw, znw)
        side += fst.astype("<u4").tobytes()
        side += zst.astype("<u4").tobytes()
        side += struct.pack("<I", 0)            # reserved
        side += zlib.compress(
            flag_f.astype("<u2").tobytes() + nz_f.astype("<u2").tobytes(), 9)
        return p_flags + p_nz, side

    def _decode_u8(self, payload: bytes, blob: bytes) -> np.ndarray:
        n, n_nz, cap, zero_sym, fill, s_flags, s_nz, fnw, znw = \
            struct.unpack_from("<QQIBBIIII", blob, 0)
        off = 38
        fst = np.frombuffer(blob, "<u4", s_flags, off).astype(np.uint32)
        off += 4 * s_flags
        zst = np.frombuffer(blob, "<u4", s_nz, off).astype(np.uint32)
        off += 4 * s_nz + 4
        tabs = np.frombuffer(zlib.decompress(blob[off:]), "<u2")
        flag_f = tabs[:256].astype(np.uint32)
        nz_f = tabs[256:].astype(np.uint32)
        n8 = n + ((-n) % (8 * s_flags))
        fb = _decode_lanes(_wire_words(payload, fnw), fst, flag_f[None],
                           _cums(flag_f)[None], n8 // 8 // s_flags, None,
                           self.device)
        flags = unpack_flags(fb.t().reshape(-1))
        nz = _decode_lanes(_wire_words(payload[2 * fnw:], znw), zst,
                           nz_f[None], _cums(nz_f)[None], cap // s_nz, None,
                           self.device).t().reshape(-1)
        # the k-th flagged position takes the k-th symbol of the prefix
        rank = torch.cumsum(flags.to(torch.int64), 0) - 1
        out = torch.where(flags, nz[rank.clamp_(0, cap - 1)],
                          torch.tensor(zero_sym, dtype=torch.uint8,
                                       device=self.device))
        return out[:n].cpu().numpy()

    def encode(self, arr: np.ndarray) -> Tuple[bytes, Dict[str, bytes]]:
        arr = self.check_dtype(arr)
        if arr.dtype != np.uint8:
            flat = arr.reshape(-1)
            lo, s1 = self._encode_u8((flat & 0xFF).astype(np.uint8))
            hi, s2 = self._encode_u8((flat >> 8).astype(np.uint8))
            head = struct.pack(f"<BIIB{arr.ndim}I", 1, len(lo), len(s1),
                               arr.ndim, *arr.shape)
            return lo + hi, {"srans_model": head + s1 + s2}
        payload, side = self._encode_u8(arr.reshape(-1))
        head = struct.pack(f"<BIIB{arr.ndim}I", 0, len(payload), len(side),
                           arr.ndim, *arr.shape)
        return payload, {"srans_model": head + side}

    def decode(self, payload: bytes, side: Dict[str, bytes]) -> np.ndarray:
        blob = side["srans_model"]
        mode, split, s1_len, ndim = struct.unpack_from("<BIIB", blob, 0)
        shape = struct.unpack_from(f"<{ndim}I", blob, 10)
        body = blob[10 + 4 * ndim:]
        if mode == 0:
            return self._decode_u8(payload, body).reshape(shape)
        lo = self._decode_u8(payload[:split], body[:s1_len])
        hi = self._decode_u8(payload[split:], body[s1_len:])
        return ((hi.astype(np.uint16) << 8) | lo).reshape(shape)
