"""Interleaved multi-stream canonical Huffman, ``ihuff`` (port of
vcf_tpu/entropy/interleaved.py; torch).

The symbol plane is split into S interleaved streams (row-major round
robin), each Huffman-coded on its own with one shared canonical code
(lengths capped at 14 bits, so a single 2^14-entry decode table).

* Encode: per-symbol code and length by a table gather, per-stream bit
  offsets as an exclusive running sum of the lengths, then each code
  split into the (at most 3) bytes it touches and added into the packed
  buffer with one `index_add_`.  The codes in a byte occupy disjoint
  bits, so the sum of their pieces is their OR.  (vcf_tpu assembles each
  output byte by a binary search of the offsets instead, a TPU form.)
* Decode: a loop over the L symbol positions, vectorised over the S
  streams: a 3-byte window per stream (prebuilt for every byte position),
  one table lookup, the stream's bit cursor advanced.

Both run as torch ops on the caller's device.  The serialized format is
vcf_tpu's (`itree` sidecar: S, L, n, per-stream byte counts, the 256 code
lengths), byte for byte.
"""

from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np
import torch

from vcf_tpu_torch.entropy.base import EntropyCodec
from vcf_tpu_torch.entropy.huffman import (MAX_CODE_LEN_U8, canonical_codes,
                                           code_lengths_from_counts)

MAX_LEN = MAX_CODE_LEN_U8  # 14: single-level decode table of 2^14 entries


def plan_streams(n_symbols: int, n_streams: int) -> Tuple[int, int]:
    """(L symbols per stream, padded total)."""
    l = -(-n_symbols // n_streams)
    return l, l * n_streams


def capacity_bytes(l: int) -> int:
    """Per-stream byte capacity (worst case MAX_LEN bits a symbol, and 4
    guard bytes for the decoder's window reads)."""
    return (l * MAX_LEN + 7) // 8 + 4


def encode_streams(syms: torch.Tensor, codes: np.ndarray,
                   lens: np.ndarray, cap: int):
    """syms (S, L) uint8, codes (256,), lens (256,) -> (packed (S, cap)
    uint8, total_bits (S,) int64), on syms' device."""
    dev = syms.device
    s, _ = syms.shape
    sym = syms.to(torch.int64)
    code = torch.from_numpy(codes.astype(np.int64)).to(dev)[sym]
    ln = torch.from_numpy(lens.astype(np.int64)).to(dev)[sym]
    ends = torch.cumsum(ln, dim=1)
    offsets = ends - ln                          # start bit of each symbol
    total_bits = ends[:, -1]
    r = offsets & 7
    # the code left-aligned at bit r of a 32-bit word (r + ln <= 21: it
    # spans at most 3 bytes, the top three of the word)
    word = code << (32 - ln - r)
    first = offsets >> 3
    first = first + (torch.arange(s, device=dev) * cap)[:, None]
    packed = torch.zeros(s * cap, dtype=torch.int32, device=dev)
    for j, shift in enumerate((24, 16, 8)):
        packed.index_add_(0, (first + j).reshape(-1),
                          ((word >> shift) & 0xFF).to(torch.int32).reshape(-1))
    return packed.to(torch.uint8).reshape(s, cap), total_bits


def build_decode_tables(lengths: np.ndarray):
    """(2^MAX_LEN,) symbol and length tables of the canonical code."""
    codes = canonical_codes(lengths)
    table_sym = np.zeros(1 << MAX_LEN, dtype=np.int32)
    table_len = np.zeros(1 << MAX_LEN, dtype=np.int32)
    for s in np.nonzero(lengths)[0]:
        ln = int(lengths[s])
        prefix = int(codes[s]) << (MAX_LEN - ln)
        span = 1 << (MAX_LEN - ln)
        table_sym[prefix: prefix + span] = s
        table_len[prefix: prefix + span] = ln
    return table_sym, table_len


def decode_streams(packed: torch.Tensor, table_sym: np.ndarray,
                   table_len: np.ndarray, l: int) -> torch.Tensor:
    """packed (S, cap) uint8 -> symbols (S, l) uint8, on packed's device."""
    dev = packed.device
    s, cap = packed.shape
    b = packed.to(torch.int64)
    # the 24-bit window starting at every byte position
    win = torch.zeros_like(b)
    win[:, :cap - 2] = (b[:, :-2] << 16) | (b[:, 1:-1] << 8) | b[:, 2:]
    win = win.reshape(-1)
    tsym = torch.from_numpy(table_sym.astype(np.uint8)).to(dev)
    tlen = torch.from_numpy(table_len.astype(np.int64)).to(dev)
    row_base = torch.arange(s, device=dev) * cap
    bitpos = torch.zeros(s, dtype=torch.int64, device=dev)
    out = torch.empty((l, s), dtype=torch.uint8, device=dev)
    mask = (1 << MAX_LEN) - 1
    for t in range(l):
        w = win[row_base + (bitpos >> 3)]
        window = (w >> (24 - MAX_LEN - (bitpos & 7))) & mask
        out[t] = tsym[window]
        bitpos += tlen[window]
    return out.t()


class DeviceHuffman:
    """Histogram -> host code build -> device pack, everything on the
    device but the 256-entry tables."""

    def __init__(self, n_streams: int = 4096):
        self.n_streams = n_streams

    def encode(self, flat_u8: torch.Tensor):
        """flat (N,) uint8 tensor -> (packed (S, cap), total_bits (S,),
        lengths (256,) uint8, meta)."""
        if flat_u8.dim() != 1:
            raise ValueError(f"expected flat (N,) symbols, got "
                             f"{tuple(flat_u8.shape)}")
        n = flat_u8.shape[0]
        l, padded = plan_streams(n, self.n_streams)
        cap = capacity_bytes(l)
        x = torch.zeros(padded, dtype=torch.uint8, device=flat_u8.device)
        x[:n] = flat_u8
        counts = torch.bincount(x.to(torch.int64), minlength=256).cpu().numpy()
        lengths = code_lengths_from_counts(counts, MAX_LEN)
        codes = canonical_codes(lengths)
        syms = x.reshape(l, self.n_streams).t()      # round-robin interleave
        packed, total_bits = encode_streams(syms, codes, lengths, cap)
        return packed, total_bits, lengths, {"n": n, "l": l, "cap": cap}

    def decode(self, packed: torch.Tensor, lengths: np.ndarray, meta
               ) -> torch.Tensor:
        table_sym, table_len = build_decode_tables(lengths)
        syms = decode_streams(packed, table_sym, table_len, meta["l"])
        return syms.t().reshape(-1)[: meta["n"]]     # undo the interleave


class InterleavedHuffmanCodec(EntropyCodec):
    """Serialized form: a header (S, L, n, ndim, shape, per-stream byte
    counts u32, code lengths) in the sidecar; the payload the streams'
    bytes one after another.  Runs on `device`."""

    file_extension = ".ihuf"

    def __init__(self, n_streams: int = 4096, *, device):
        self.n_streams = n_streams
        self.device = torch.device(device)

    @classmethod
    def from_config(cls, config=None, *, device):
        return cls(device=device)

    @staticmethod
    def pick_streams(n: int, requested: int) -> int:
        """Scale the stream count to the input so per-stream overhead
        (byte alignment + 4-byte length entry) stays < ~1%."""
        return int(max(8, min(requested, n // 4096 or 8)))

    def _encode_u8(self, flat: np.ndarray) -> Tuple[bytes, bytes]:
        dh = DeviceHuffman(self.pick_streams(flat.size, self.n_streams))
        packed, total_bits, lengths, meta = dh.encode(
            torch.from_numpy(flat).to(self.device))
        nbytes = (total_bits + 7) // 8
        keep = (torch.arange(meta["cap"], device=self.device)[None, :]
                < nbytes[:, None])
        payload = torch.masked_select(packed, keep).cpu().numpy().tobytes()
        blob = struct.pack("<IIQ", dh.n_streams, meta["l"], meta["n"])
        blob += nbytes.cpu().numpy().astype("<u4").tobytes()
        blob += lengths.astype(np.uint8).tobytes()
        return payload, blob

    def _decode_u8(self, payload: bytes, blob: bytes) -> np.ndarray:
        n_streams, l, n = struct.unpack_from("<IIQ", blob, 0)
        off = 16
        nbytes = np.frombuffer(blob, "<u4", n_streams, off).astype(np.int64)
        off += 4 * n_streams
        lengths = np.frombuffer(blob, np.uint8, 256, off)
        cap = capacity_bytes(l)
        keep = np.arange(cap)[None, :] < nbytes[:, None]
        packed = np.zeros((n_streams, cap), np.uint8)
        packed[keep] = np.frombuffer(payload, np.uint8, int(nbytes.sum()))
        flat = DeviceHuffman(n_streams).decode(
            torch.from_numpy(packed).to(self.device), lengths,
            {"n": n, "l": l, "cap": cap})
        return flat.cpu().numpy()

    def encode(self, arr: np.ndarray) -> Tuple[bytes, Dict[str, bytes]]:
        arr = self.check_dtype(arr)
        if arr.dtype != np.uint8:
            # uint16 -> two byte planes
            flat = arr.reshape(-1)
            p1, s1 = self._encode_u8((flat & 0xFF).astype(np.uint8))
            p2, s2 = self._encode_u8((flat >> 8).astype(np.uint8))
            head = struct.pack(f"<BIB{arr.ndim}I", 1, len(p1), arr.ndim,
                               *arr.shape)
            return p1 + p2, {"itree": head + s1 + s2}
        payload, sideblob = self._encode_u8(arr.reshape(-1))
        head = struct.pack(f"<BIB{arr.ndim}I", 0, len(payload), arr.ndim,
                           *arr.shape)
        return payload, {"itree": head + sideblob}

    def decode(self, payload: bytes, side: Dict[str, bytes]) -> np.ndarray:
        blob = side["itree"]
        mode, split, ndim = struct.unpack_from("<BIB", blob, 0)
        shape = struct.unpack_from(f"<{ndim}I", blob, 6)
        body = blob[6 + 4 * ndim:]
        if mode == 0:
            return self._decode_u8(payload, body).reshape(shape)
        # uint16: two sub-blobs of 16 + 4*S + 256 bytes each
        (s1,) = struct.unpack_from("<I", body, 0)
        sub1_len = 16 + 4 * s1 + 256
        lo = self._decode_u8(payload[:split], body[:sub1_len])
        hi = self._decode_u8(payload[split:], body[sub1_len:])
        return ((hi.astype(np.uint16) << 8) | lo).reshape(shape)
