"""TIFF entropy codec (zlib/deflate-compressed strips).

Capability parity with the reference's default entropy stage,
src/TIFF.py:23-39 (`tifffile.imwrite(..., compression='zlib')`).
Self-contained little-endian baseline TIFF writer/reader: one IFD,
Compression=8 (Adobe Deflate), chunky RGB or grayscale, 8/16-bit,
strip-per-image.  The reader additionally accepts multi-strip files,
LZW (5), PackBits (32773) and the horizontal-differencing predictor,
so TIFFs from cv2/imageio/tifffile round-trip (tests/test_containers.py).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

from vcf_tpu_torch.entropy.base import EntropyCodec

# TIFF tag ids
_T_WIDTH, _T_HEIGHT, _T_BPS, _T_COMPRESSION = 256, 257, 258, 259
_T_PHOTOMETRIC, _T_STRIP_OFFSETS, _T_SPP = 262, 273, 277
_T_ROWS_PER_STRIP, _T_STRIP_COUNTS, _T_PLANARCONF = 278, 279, 284
_T_SAMPLEFORMAT = 339

_SHORT, _LONG = 3, 4


def write_tiff(arr: np.ndarray, level: int = 6) -> bytes:
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    bits = 8 if arr.dtype == np.uint8 else 16
    data = zlib.compress(np.ascontiguousarray(arr).tobytes(), level)

    entries = []

    def entry(tag, typ, count, value):
        entries.append((tag, typ, count, value))

    # Values that don't fit inline go after the IFD; collect them.
    extra: list = []

    header_size = 8
    # layout: header | image data | IFD | extra values
    strip_offset = header_size
    ifd_offset = strip_offset + len(data)
    n_entries_known = 11 if c >= 1 else 10

    def extra_offset_base(n_entries):
        return ifd_offset + 2 + n_entries * 12 + 4

    entry(_T_WIDTH, _LONG, 1, w)
    entry(_T_HEIGHT, _LONG, 1, h)
    bps_value = None
    if c == 1:
        entry(_T_BPS, _SHORT, 1, bits)
    else:
        bps_value = struct.pack(f"<{c}H", *([bits] * c))
        entry(_T_BPS, _SHORT, c, ("extra", bps_value))
    entry(_T_COMPRESSION, _SHORT, 1, 8)  # Adobe Deflate
    entry(_T_PHOTOMETRIC, _SHORT, 1, 2 if c == 3 else 1)
    entry(_T_STRIP_OFFSETS, _LONG, 1, strip_offset)
    entry(_T_SPP, _SHORT, 1, c)
    entry(_T_ROWS_PER_STRIP, _LONG, 1, h)
    entry(_T_STRIP_COUNTS, _LONG, 1, len(data))
    entry(_T_PLANARCONF, _SHORT, 1, 1)
    entry(_T_SAMPLEFORMAT, _SHORT, 1, 1)

    n = len(entries)
    extra_base = extra_offset_base(n)
    out_entries = b""
    extra_blob = b""
    for tag, typ, count, value in sorted(entries, key=lambda e: e[0]):
        if isinstance(value, tuple) and value[0] == "extra":
            blob = value[1]
            out_entries += struct.pack("<HHII", tag, typ, count, extra_base + len(extra_blob))
            extra_blob += blob
        else:
            if typ == _SHORT and count == 1:
                out_entries += struct.pack("<HHIHH", tag, typ, count, value, 0)
            else:
                out_entries += struct.pack("<HHII", tag, typ, count, value)
    header = b"II" + struct.pack("<HI", 42, ifd_offset)
    ifd = struct.pack("<H", n) + out_entries + struct.pack("<I", 0)
    return header + data + ifd + extra_blob


def _lzw_decode(data: bytes) -> bytes:
    """TIFF-variant LZW (spec section 13): MSB-first 9..12-bit codes,
    ClearCode 256, EOI 257, with the "early change" code-width bump at
    next_code == 2^width - 1.  Needed to read LZW TIFFs from common
    writers (cv2 compresses TIFF with LZW by default)."""
    clear_code, eoi = 256, 257
    out = bytearray()
    base = [bytes([i]) for i in range(256)] + [b"", b""]
    table = list(base)
    width, next_code = 9, 258
    buf = nbits = pos = 0
    ln = len(data)
    prev = None
    while True:
        while nbits < width:
            if pos >= ln:
                return bytes(out)
            buf = (buf << 8) | data[pos]
            pos += 1
            nbits += 8
        code = (buf >> (nbits - width)) & ((1 << width) - 1)
        nbits -= width
        if code == clear_code:
            table = list(base)
            width, next_code = 9, 258
            prev = None
            continue
        if code == eoi:
            return bytes(out)
        if prev is None:
            entry = table[code]
        elif code < next_code:
            entry = table[code]
            table.append(prev + entry[:1])
            next_code += 1
        elif code == next_code:
            entry = prev + prev[:1]
            table.append(entry)
            next_code += 1
        else:
            raise ValueError("corrupt LZW stream")
        out += entry
        if next_code == (1 << width) - 1 and width < 12:
            width += 1
        prev = entry


def _packbits_decode(data: bytes) -> bytes:
    """TIFF PackBits (compression 32773) run-length decoding."""
    out = bytearray()
    i, ln = 0, len(data)
    while i < ln:
        n = data[i]
        i += 1
        if n < 128:
            out += data[i : i + n + 1]
            i += n + 1
        elif n > 128:
            out += data[i : i + 1] * (257 - n)
            i += 1
    return bytes(out)


_T_PREDICTOR = 317


def read_tiff(blob: bytes) -> np.ndarray:
    if blob[:2] not in (b"II", b"MM"):
        raise ValueError("not a TIFF")
    bo = "<" if blob[:2] == b"II" else ">"
    magic, ifd_offset = struct.unpack_from(f"{bo}HI", blob, 2)
    if magic != 42:
        raise ValueError("bad TIFF magic")
    (n,) = struct.unpack_from(f"{bo}H", blob, ifd_offset)
    tags = {}
    for i in range(n):
        off = ifd_offset + 2 + i * 12
        tag, typ, count = struct.unpack_from(f"{bo}HHI", blob, off)
        if typ == _SHORT:
            size = 2 * count
            fmt = f"{bo}{count}H"
        elif typ == _LONG:
            size = 4 * count
            fmt = f"{bo}{count}I"
        else:
            continue
        if size <= 4:
            values = struct.unpack_from(fmt, blob, off + 8)
        else:
            (ptr,) = struct.unpack_from(f"{bo}I", blob, off + 8)
            values = struct.unpack_from(fmt, blob, ptr)
        tags[tag] = values
    w = tags[_T_WIDTH][0]
    h = tags[_T_HEIGHT][0]
    c = tags.get(_T_SPP, (1,))[0]
    bits = tags[_T_BPS][0]
    compression = tags.get(_T_COMPRESSION, (1,))[0]
    offsets = tags[_T_STRIP_OFFSETS]
    counts = tags[_T_STRIP_COUNTS]
    if compression in (8, 32946):  # deflate
        expand = zlib.decompress
    elif compression == 5:  # LZW
        expand = _lzw_decode
    elif compression == 32773:  # PackBits
        expand = _packbits_decode
    elif compression == 1:
        expand = lambda b: b  # noqa: E731
    else:
        raise ValueError(f"unsupported TIFF compression {compression}")
    raw = b"".join(
        expand(blob[o : o + cnt]) for o, cnt in zip(offsets, counts)
    )
    dtype = np.uint8 if bits == 8 else np.dtype(f"{bo}u2")
    arr = np.frombuffer(raw, dtype=dtype, count=h * w * c).reshape(h, w, c)
    if tags.get(_T_PREDICTOR, (1,))[0] == 2:  # horizontal differencing
        arr = np.cumsum(arr.astype(np.int64), axis=1)
        arr = (arr & (0xFF if bits == 8 else 0xFFFF))
    arr = arr.astype(np.uint8 if bits == 8 else np.uint16)
    return arr[:, :, 0] if c == 1 else arr


class TIFFCodec(EntropyCodec):
    file_extension = ".tif"

    def __init__(self, level: int = 6):
        self.level = level

    @classmethod
    def from_config(cls, config=None):
        return cls(level=getattr(config, "zlib_level", 6))

    def encode(self, arr: np.ndarray) -> Tuple[bytes, Dict[str, bytes]]:
        arr = self.check_dtype(arr)
        return write_tiff(arr, self.level), {}

    def decode(self, payload: bytes, side: Dict[str, bytes]) -> np.ndarray:
        return read_tiff(payload)
