"""Context-Based Adaptive Arithmetic Codec (CBAAC; port of
vcf_tpu/entropy/cbaac.py).

Capability parity with src/CBAAC.py: order-N adaptive model per byte
context (window seeded with the PAD symbol, shared ctx_init/ctx_mask
with CBAHC — src/CBAHC.py:123-153 semantics), frequency increments with
rescale when the total reaches 16384 (src/CBAAC.py:34-38),
dict-of-models context manager (:49-69), and the array shape carried as
uint32 dims (:85-88 — we keep it in a sidecar segment consistent with
the rest of this framework).

The arithmetic coder itself is a carry-less 32-bit range coder in the
port's native coder (vcf_rc_encode/decode); `py_rc_encode` /
`py_rc_decode` are its pure-Python plain versions (tests only).  uint16 input is coded as low/high
byte planes (documented deviation; the reference models 65536-entry
frequency tables).
"""

from __future__ import annotations

import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Tuple

import numpy as np

from vcf_tpu_torch import native
from vcf_tpu_torch.entropy.base import EntropyCodec
from vcf_tpu_torch.entropy.cbahc import (ctx_init, ctx_mask, tiled_decode,
                                         tiled_encode)

_RC_TOP = 1 << 24
_RC_BOT = 1 << 16
_MAX_TOTAL = 16384
_M32 = 0xFFFFFFFF


class _Model:
    """Reference AdaptiveModel update law (src/CBAAC.py:34-47): Laplace
    init (all 1s), +1 increments, rescale `(f >> 1) + 1` fired when the
    total BEFORE the increment had reached max_freq (the reference
    tests its stale `self.total`, recomputed only at the end)."""

    __slots__ = ("freq", "total")

    def __init__(self):
        self.freq = np.ones(256, dtype=np.int64)
        self.total = 256

    def update(self, sym: int):
        prev_total = self.total
        self.freq[sym] += 1
        self.total += 1
        if prev_total >= _MAX_TOTAL:
            self.freq = (self.freq >> 1) + 1
            self.total = int(self.freq.sum())


def py_rc_encode(data: np.ndarray, order: int) -> bytes:
    models: Dict[int, _Model] = {}
    mask = ctx_mask(order)
    out = bytearray()
    low, rng = 0, _M32
    ctx = ctx_init(order)
    for s in data.tolist():
        m = models.get(ctx)
        if m is None:
            m = models[ctx] = _Model()
        cum = int(m.freq[:s].sum())
        f = int(m.freq[s])
        rng //= m.total
        low = (low + cum * rng) & _M32
        rng = (rng * f) & _M32
        while True:
            if (low ^ (low + rng)) & _M32 < _RC_TOP:
                pass
            elif rng < _RC_BOT:
                rng = (-low) & (_RC_BOT - 1)
            else:
                break
            out.append((low >> 24) & 0xFF)
            low = (low << 8) & _M32
            rng = (rng << 8) & _M32
        m.update(s)
        if order:
            ctx = ((ctx << 9) | s) & mask
    for _ in range(4):
        out.append((low >> 24) & 0xFF)
        low = (low << 8) & _M32
    return bytes(out)


def py_rc_decode(payload: bytes, n_symbols: int, order: int) -> np.ndarray:
    models: Dict[int, _Model] = {}
    mask = ctx_mask(order)
    src = payload + b"\x00" * 8
    pos = 4
    code = int.from_bytes(src[:4], "big")
    low, rng = 0, _M32
    out = np.empty(n_symbols, dtype=np.uint8)
    ctx = ctx_init(order)
    for i in range(n_symbols):
        m = models.get(ctx)
        if m is None:
            m = models[ctx] = _Model()
        rng //= m.total
        scaled = ((code - low) & _M32) // rng
        cumsum = np.cumsum(m.freq)
        s = int(np.searchsorted(cumsum, scaled, side="right"))
        cum = int(cumsum[s - 1]) if s > 0 else 0
        f = int(m.freq[s])
        low = (low + cum * rng) & _M32
        rng = (rng * f) & _M32
        while True:
            if (low ^ (low + rng)) & _M32 < _RC_TOP:
                pass
            elif rng < _RC_BOT:
                rng = (-low) & (_RC_BOT - 1)
            else:
                break
            code = ((code << 8) | src[pos]) & _M32
            pos += 1
            low = (low << 8) & _M32
            rng = (rng << 8) & _M32
        m.update(s)
        out[i] = s
        if order:
            ctx = ((ctx << 9) | s) & mask
    return out


def _encode_tiled(flat_u8: np.ndarray, order: int, tiles: int) -> bytes:
    return tiled_encode(flat_u8, order, tiles, native.rc_encode)


def _decode_tiled(blob: bytes, n: int, order: int, tiles: int) -> np.ndarray:
    return tiled_decode(blob, n, order, tiles, native.rc_decode)


class CBAACCodec(EntropyCodec):
    file_extension = ".adpt_arith"

    def __init__(self, order: int = 1, tiles: int = 1):
        self.order = order
        self.tiles = max(1, tiles)

    @classmethod
    def from_config(cls, config=None):
        return cls(
            order=getattr(config, "context_order", 1),
            tiles=getattr(config, "context_tiles", 1),
        )

    def encode(self, arr: np.ndarray) -> Tuple[bytes, Dict[str, bytes]]:
        arr = self.check_dtype(arr)
        flat = arr.reshape(-1)
        nbits = 8 if arr.dtype == np.uint8 else 16
        if nbits == 8:
            body = _encode_tiled(flat, self.order, self.tiles)
            split = len(body)
        else:
            lo = _encode_tiled((flat & 0xFF).astype(np.uint8), self.order, self.tiles)
            hi = _encode_tiled((flat >> 8).astype(np.uint8), self.order, self.tiles)
            body = lo + hi
            split = len(lo)
        # shape rides in the stream header as uint32 dims (CBAAC.py:85-88)
        header = struct.pack(
            f"<BBBIB{arr.ndim}I",
            nbits, self.order, self.tiles, split, arr.ndim, *arr.shape,
        )
        return header + body, {}

    def decode(self, payload: bytes, side: Dict[str, bytes]) -> np.ndarray:
        nbits, order, tiles, split, ndim = struct.unpack_from("<BBBIB", payload, 0)
        shape = struct.unpack_from(f"<{ndim}I", payload, 8)
        body = payload[8 + 4 * ndim :]
        n = int(np.prod(shape))
        if nbits == 8:
            out = _decode_tiled(body, n, order, tiles).astype(np.uint8)
        else:
            lo = _decode_tiled(body[:split], n, order, tiles).astype(np.uint16)
            hi = _decode_tiled(body[split:], n, order, tiles).astype(np.uint16)
            out = (hi << 8) | lo
        return out.reshape(shape)
