"""PNG entropy codec — self-contained writer/reader (port of
vcf_tpu/entropy/png.py).

Capability parity with src/PNG.py (imageio/Pillow-backed in the
reference; asserts uint8/uint16).  Implemented from the PNG spec
directly so 16-bit RGB works without Pillow: IHDR/IDAT/IEND chunks,
zlib-compressed scanlines.  The encoder uses per-row adaptive filtering
(chooses among filter types 0/1/2/3/4 by minimum-sum-of-absolutes, the
standard heuristic); the decoder handles all five filter types, 8/16
bit depth, gray/RGB/RGBA, non-interlaced.

The scanline filter loops run in the native coder (`vcf_png_filter`,
`vcf_png_unfilter`); `filter_rows_plain` / `unfilter_rows_plain` are
their plain numpy versions, which the tests hold byte-identical to them.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

from vcf_tpu_torch import native
from vcf_tpu_torch.entropy.base import EntropyCodec

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# color type -> channels
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def filter_rows_plain(raw: np.ndarray, bpp: int) -> bytes:
    """Plain version of `native.png_filter`, the per-row adaptive
    filtering of (H, stride) uint8 scanlines: encode-side filtering predicts
    from the RAW previous row, so all five candidates and the
    minimum-sum-of-absolutes choice are computed for the whole image at
    once."""
    h, stride = raw.shape
    up = np.zeros_like(raw)
    up[1:] = raw[:-1]
    left = np.zeros_like(raw)
    left[:, bpp:] = raw[:, :-bpp]
    upleft = np.zeros_like(raw)
    upleft[1:, bpp:] = raw[:-1, :-bpp]
    # candidate filtered rows (uint8 wraparound arithmetic)
    sub = raw - left
    upf = raw - up
    avg = raw - ((left.astype(np.uint16) + up.astype(np.uint16)) // 2).astype(np.uint8)
    # Paeth predictor
    p = left.astype(np.int32) + up.astype(np.int32) - upleft.astype(np.int32)
    pa = np.abs(p - left.astype(np.int32))
    pb = np.abs(p - up.astype(np.int32))
    pc = np.abs(p - upleft.astype(np.int32))
    paeth_pred = np.where(
        (pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft)
    )
    paeth = raw - paeth_pred
    cands = np.stack([raw, sub, upf, avg, paeth])        # (5, H, stride)
    costs = np.abs(cands.astype(np.int8).astype(np.int32)).sum(axis=2)
    ftype = np.argmin(costs, axis=0)                      # (H,) first-wins
    out = np.empty((h, stride + 1), np.uint8)
    out[:, 0] = ftype
    out[:, 1:] = np.take_along_axis(cands, ftype[None, :, None], axis=0)[0]
    return out.tobytes()


def unfilter_rows_plain(data: np.ndarray, h: int, stride: int,
                        bpp: int) -> np.ndarray:
    """Plain version of `native.png_unfilter`, which reverses the
    scanline filters (the sequential direction: each byte predicts from
    reconstructed neighbors): filters 0/2 whole-row, filter 1 as a
    per-lane mod-256 cumulative sum, a loop only for Average/Paeth."""
    rows = data.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = int(rows[y, 0])
        cur = rows[y, 1:].astype(np.int32)
        if ftype == 0:
            rec = cur
        elif ftype == 1:  # Sub: mod-256 addition is associative -> per-
            # lane cumulative sum over the bpp-strided byte lanes
            rec = cur.copy()
            for lane in range(bpp):
                rec[lane::bpp] = np.cumsum(cur[lane::bpp]) & 0xFF
        elif ftype == 2:  # Up
            rec = (cur + prev) & 0xFF
        elif ftype == 3:  # Average
            rec = cur.copy()
            for x in range(stride):
                left = rec[x - bpp] if x >= bpp else 0
                rec[x] = (rec[x] + ((left + prev[x]) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            rec = cur.copy()
            for x in range(stride):
                a = rec[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                rec[x] = (rec[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = rec.astype(np.uint8)
        prev = rec
    return out


def write_png(arr: np.ndarray, level: int = 6) -> bytes:
    """Encode a (H, W) or (H, W, C) uint8/uint16 array as PNG bytes."""
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    depth = 8 if arr.dtype == np.uint8 else 16
    if depth == 16:
        raw = arr.astype(">u2").reshape(h, -1).view(np.uint8)
    else:
        raw = arr.reshape(h, -1)
    bpp = c * (depth // 8)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, 0)
    filtered = native.png_filter(raw, bpp)
    idat = _deflate(filtered, level)
    return _PNG_SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", idat) + _chunk(b"IEND", b"")


def _deflate(data: bytes, level: int) -> bytes:
    """zlib-format compress: libdeflate when present (2-4x faster, still
    standard inflate on the read side), zlib module otherwise."""
    if native.deflate_available():
        return native.zlib_compress(data, level)
    return zlib.compress(data, level)


def _inflate(data: bytes, out_size: int) -> bytes:
    if native.deflate_available():
        return native.zlib_decompress(data, out_size)
    return zlib.decompress(data)


def read_png(blob: bytes) -> np.ndarray:
    if blob[:8] != _PNG_SIG:
        raise ValueError("not a PNG")
    pos = 8
    idat = b""
    ihdr = None
    while pos < len(blob):
        (length,) = struct.unpack_from(">I", blob, pos)
        tag = blob[pos + 4 : pos + 8]
        data = blob[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat += data
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG missing IHDR")
    w, h, depth, color_type, comp, filt, interlace = ihdr
    if interlace:
        raise ValueError("interlaced PNG unsupported")
    if color_type == 3:
        raise ValueError("palette PNG unsupported")
    c = _CHANNELS[color_type]
    bpp = c * (depth // 8)
    stride = w * bpp
    raw = np.frombuffer(_inflate(idat, h * (stride + 1)), np.uint8)
    rows = native.png_unfilter(raw, h, stride, bpp)
    if depth == 16:
        arr = rows.reshape(h, w, c, 2).astype(np.uint16)
        arr = (arr[..., 0] << 8) | arr[..., 1]
    else:
        arr = rows.reshape(h, w, c)
    return arr[:, :, 0] if c == 1 else arr


class PNGCodec(EntropyCodec):
    file_extension = ".png"

    def __init__(self, level: int = 6):
        self.level = level

    @classmethod
    def from_config(cls, config=None):
        return cls(level=getattr(config, "zlib_level", 6))

    def encode(self, arr: np.ndarray) -> Tuple[bytes, Dict[str, bytes]]:
        arr = self.check_dtype(arr)
        return write_png(arr, self.level), {}

    def decode(self, payload: bytes, side: Dict[str, bytes]) -> np.ndarray:
        return read_png(payload)
