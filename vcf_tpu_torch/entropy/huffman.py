"""Static canonical Huffman entropy codec (port of
vcf_tpu/entropy/huffman.py).

Capability parity with src/Huffman.py (external `huffman_coding` +
bitarray in the reference): flatten the index array, build a Huffman
code from symbol frequencies, emit a bitstream; the code table and the
array shape ride as side information (the reference pickles the tree to
`{fn}_huffman_tree.pkl.gz`, src/Huffman.py:48-50).

TPU-era design instead of a pickled tree:

* *Canonical* codes — the sidecar stores only per-symbol code lengths
  (zlib-compressed); encoder and decoder rebuild identical codes.
* *Length-limited* codes (<= 14 bits for uint8 data) so decoding is a
  single table lookup per symbol; the limit costs < 0.1% rate on real
  index planes.
* *Chunked streams* — the payload frames independent byte-aligned
  chunks (header: u32 n_chunks, u64 chunk_syms, u64 byte_len per
  chunk), so encode and decode parallelize across cores and, in the
  sharded path, across per-tile streams (SURVEY §7.3).

The hot loops run in the port's native coder (`vcf_tpu_torch.native`);
`pack_codes` / `unpack_codes` / `pack_chunked` / `unpack_chunked` are
their plain NumPy/Python versions, byte-identical to them and used only
by the tests.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import heapq

import numpy as np

from vcf_tpu_torch import native
from vcf_tpu_torch.entropy.base import EntropyCodec

MAX_CODE_LEN_U8 = 14   # guarantees single-table decode
MAX_CODE_LEN_U16 = 30
CHUNK_SYMS = 8 << 20   # symbols per independent stream chunk

# Zero-run extension: 32 extra symbols, RUN_j = a run of 2^j copies of
# the dominant symbol (j up to 31 so a fully-flat 2^31-symbol plane is
# one run).  An order-0 Huffman code cannot rate below 1 bit/symbol, so
# ~90%-zero quantized planes floor at ~1 bpp (VERDICT r2 weak item 7);
# coding runs by their binary decomposition (<= popcount(run) symbols
# per run) removes the floor while staying a plain static-Huffman
# stream.  Reference role: src/Huffman.py:27-56's entropy stage at sane
# rates on sparse index planes.
N_RUN_SYMS = 32
RLE_ALPHABET = 256 + N_RUN_SYMS


def _popcount(x: np.ndarray) -> np.ndarray:
    v = x.astype(np.uint32)
    c = np.zeros_like(v)
    while True:
        c += v & 1
        v >>= 1
        if not v.any():
            return c.astype(np.int64)


def rle_encode(flat: np.ndarray, z: int) -> np.ndarray:
    """uint8 stream -> int32 extended-alphabet stream: literals (!= z)
    kept as-is, each maximal run of `z` emitted as RUN_j symbols for the
    set bits of its length, LSB-first.  Fully vectorized."""
    n = flat.size
    lit_idx = np.nonzero(flat != z)[0]
    l = lit_idx.size
    prev = np.concatenate(([-1], lit_idx, [n]))
    gaps = np.diff(prev) - 1          # (l+1,): z-run before each literal + tail
    run_counts = _popcount(gaps)      # run symbols emitted per gap
    sizes = run_counts + 1
    sizes[-1] -= 1                    # no literal after the tail gap
    starts = np.concatenate(([0], np.cumsum(sizes[:-1])))
    out = np.empty(int(sizes.sum()), np.int32)
    if l:
        out[starts[:l] + run_counts[:l]] = flat[lit_idx]
    for j in range(N_RUN_SYMS):
        has = ((gaps >> j) & 1).astype(bool)
        if not has.any():
            continue
        rank = _popcount(gaps & ((1 << j) - 1))
        out[starts[has] + rank[has]] = 256 + j
    return out


def rle_decode(ext: np.ndarray, z: int, n: int) -> np.ndarray:
    """Inverse of rle_encode.  Raises on streams whose run/literal
    lengths do not reconstruct exactly n symbols (corruption guard —
    the reference swallows corruption, SURVEY §7.3 quirk NOT kept)."""
    is_run = ext >= 256
    shifts = np.where(is_run, ext - 256, 0).astype(np.int64)
    lens = np.where(is_run, np.int64(1) << shifts, np.int64(1))
    starts = np.cumsum(lens) - lens
    if (int(starts[-1] + lens[-1]) if ext.size else 0) != n:
        raise ValueError("corrupt RLE-Huffman stream: length mismatch")
    out = np.full(n, z, np.uint8)
    lit = ~is_run
    out[starts[lit]] = ext[lit].astype(np.uint8)
    return out


def code_lengths_from_counts(counts: np.ndarray, limit: int = MAX_CODE_LEN_U16) -> np.ndarray:
    """Huffman code lengths for each symbol (0 for unused symbols).

    Deterministic: heap ties broken by insertion order (uid).  If the
    optimal code exceeds `limit` bits, counts are repeatedly halved
    (flattening the distribution) until it fits — a standard
    length-limiting heuristic with negligible rate cost.
    """
    counts = counts.astype(np.int64)
    while True:
        lengths = _code_lengths(counts)
        if lengths.max() <= limit:
            return lengths
        counts = np.where(counts > 0, (counts + 1) // 2, 0)


def _code_lengths(counts: np.ndarray) -> np.ndarray:
    symbols = np.nonzero(counts)[0]
    lengths = np.zeros(counts.shape[0], dtype=np.uint8)
    if symbols.size == 0:
        return lengths
    if symbols.size == 1:
        lengths[symbols[0]] = 1
        return lengths
    heap = []
    uid = 0
    for s in symbols:
        heap.append((int(counts[s]), uid, [int(s)]))
        uid += 1
    heapq.heapify(heap)
    while len(heap) > 1:
        f1, _, leaves1 = heapq.heappop(heap)
        f2, _, leaves2 = heapq.heappop(heap)
        for s in leaves1:
            lengths[s] += 1
        for s in leaves2:
            lengths[s] += 1
        heapq.heappush(heap, (f1 + f2, uid, leaves1 + leaves2))
        uid += 1
    return lengths


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Assign canonical codes: shorter codes first, ties by symbol value."""
    codes = np.zeros(lengths.shape[0], dtype=np.uint64)
    used = np.nonzero(lengths)[0]
    if used.size == 0:
        return codes
    order = np.lexsort((used, lengths[used]))
    seq = used[order]
    code = 0
    prev_len = int(lengths[seq[0]])
    for s in seq:
        ln = int(lengths[s])
        code <<= ln - prev_len
        codes[s] = code
        code += 1
        prev_len = ln
    return codes


def pack_codes(data: np.ndarray, codes: np.ndarray, lengths: np.ndarray) -> bytes:
    """Vectorized single-stream bitstream packing (plain version of
    `native.huffman_encode`)."""
    sym_len = lengths[data].astype(np.int64)
    sym_code = codes[data]
    offsets = np.concatenate(([0], np.cumsum(sym_len)))
    total_bits = int(offsets[-1])
    bits = np.zeros((total_bits + 7) // 8 * 8, dtype=np.uint8)
    max_len = int(sym_len.max()) if sym_len.size else 0
    for j in range(max_len):
        mask = sym_len > j
        pos = offsets[:-1][mask] + j
        shift = (sym_len[mask] - 1 - j).astype(np.uint64)
        bits[pos] = ((sym_code[mask] >> shift) & np.uint64(1)).astype(np.uint8)
    return np.packbits(bits).tobytes()


def unpack_codes(payload: bytes, n_symbols: int, lengths: np.ndarray) -> np.ndarray:
    """Table-driven single-stream decode (plain version of
    `native.huffman_decode`)."""
    codes = canonical_codes(lengths)
    max_len = int(lengths.max())
    table_sym = np.zeros(1 << max_len, dtype=np.int64)
    table_len = np.zeros(1 << max_len, dtype=np.uint8)
    for s in np.nonzero(lengths)[0]:
        ln = int(lengths[s])
        prefix = int(codes[s]) << (max_len - ln)
        span = 1 << (max_len - ln)
        table_sym[prefix : prefix + span] = s
        table_len[prefix : prefix + span] = ln
    bits = np.unpackbits(np.frombuffer(payload, dtype=np.uint8))
    bits = np.concatenate([bits, np.zeros(max_len, np.uint8)])
    weights = (1 << np.arange(max_len - 1, -1, -1)).astype(np.int64)
    out = np.empty(n_symbols, dtype=np.int64)
    pos = 0
    for i in range(n_symbols):
        window = int(bits[pos : pos + max_len] @ weights)
        out[i] = table_sym[window]
        pos += int(table_len[window])
    return out


# ---------------------------------------------------------------------------
# Chunked-format helpers (must match vcf_huf_encode8/decode8 framing)
# ---------------------------------------------------------------------------

def pack_chunked(flat: np.ndarray, codes: np.ndarray, lengths: np.ndarray,
                 chunk_syms: int = CHUNK_SYMS) -> bytes:
    n = flat.size
    n_chunks = (n + chunk_syms - 1) // chunk_syms if n else 0
    bodies = [
        pack_codes(flat[c * chunk_syms : (c + 1) * chunk_syms], codes, lengths)
        for c in range(n_chunks)
    ]
    header = struct.pack("<IQ", n_chunks, chunk_syms)
    header += b"".join(struct.pack("<Q", len(b)) for b in bodies)
    return header + b"".join(bodies)


def unpack_chunked(payload: bytes, n_symbols: int, lengths: np.ndarray) -> np.ndarray:
    n_chunks, chunk_syms = struct.unpack_from("<IQ", payload, 0)
    sizes = struct.unpack_from(f"<{n_chunks}Q", payload, 12)
    out = np.empty(n_symbols, dtype=np.int64)
    off = 12 + 8 * n_chunks
    for c in range(n_chunks):
        lo = c * chunk_syms
        hi = min(n_symbols, lo + chunk_syms)
        out[lo:hi] = unpack_codes(payload[off : off + sizes[c]], hi - lo, lengths)
        off += sizes[c]
    return out


class HuffmanCodec(EntropyCodec):
    file_extension = ".huf"

    def encode(self, arr: np.ndarray) -> Tuple[bytes, Dict[str, bytes]]:
        arr = self.check_dtype(arr)
        is_u8 = arr.dtype == np.uint8
        flat = arr.reshape(-1)
        if is_u8:
            counts = native.hist8(flat)
        else:
            counts = np.bincount(flat, minlength=65536)
        limit = MAX_CODE_LEN_U8 if is_u8 else MAX_CODE_LEN_U16
        lengths = code_lengths_from_counts(counts, limit)
        if is_u8:
            # zero-run extension: try coding dominant-symbol runs by
            # their binary decomposition; pick whichever rates smaller
            z = int(np.argmax(counts))
            if flat.size and counts[z] > flat.size // 2:
                ext = rle_encode(flat, z)
                ext_counts = np.bincount(ext, minlength=RLE_ALPHABET)
                ext_lengths = code_lengths_from_counts(
                    ext_counts, MAX_CODE_LEN_U16)
                plain_bits = int(counts @ lengths.astype(np.int64))
                rle_bits = int(ext_counts @ ext_lengths.astype(np.int64))
                if rle_bits + 8 * N_RUN_SYMS < plain_bits:
                    payload = native.huffman_encode(ext.astype(np.uint16),
                                                    ext_lengths)
                    header = struct.pack(
                        f"<BB{arr.ndim}IBQ", 2, arr.ndim, *arr.shape,
                        z, ext.size)
                    side = {"huffman_tree":
                            header + zlib.compress(ext_lengths.tobytes(), 9)}
                    return payload, side
            payload = native.huffman_encode8(flat, lengths, CHUNK_SYMS)
        else:
            payload = native.huffman_encode(flat, lengths)
        header = struct.pack(
            f"<BB{arr.ndim}I", 0 if is_u8 else 1, arr.ndim, *arr.shape
        )
        side = {"huffman_tree": header + zlib.compress(lengths.tobytes(), 9)}
        return payload, side

    def decode(self, payload: bytes, side: Dict[str, bytes]) -> np.ndarray:
        blob = side["huffman_tree"]
        dtype_code, ndim = struct.unpack_from("<BB", blob, 0)
        shape = struct.unpack_from(f"<{ndim}I", blob, 2)
        n_symbols = int(np.prod(shape))
        if dtype_code == 2:
            z, n_ext = struct.unpack_from("<BQ", blob, 2 + 4 * ndim)
            lengths = np.frombuffer(
                zlib.decompress(blob[2 + 4 * ndim + 9 :]), dtype=np.uint8)
            ext = native.huffman_decode(payload, n_ext, lengths)
            out = rle_decode(ext.astype(np.int32), z, n_symbols)
            return out.reshape(shape)
        lengths = np.frombuffer(zlib.decompress(blob[2 + 4 * ndim :]), dtype=np.uint8)
        if dtype_code == 0:
            out = native.huffman_decode8(payload, n_symbols, lengths)
            return out.reshape(shape)
        out = native.huffman_decode(payload, n_symbols, lengths)
        return out.reshape(shape)
