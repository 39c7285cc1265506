"""ctypes bindings for the port's native entropy runtime (entropy.cpp).

`load()` compiles `vcf_tpu_torch/native/entropy.cpp` with g++ on first
use (never at import) into `vcf_tpu_torch/_build/` (listed in
.gitignore), under a name that carries a hash of the source, the flags
and the host's name, so an edited source builds anew and a copy of the
tree on another machine never loads a library built for this one.  A
failed build raises: no codec falls back to its pure-Python mirror.  The mirrors stay beside
each codec (`entropy/huffman.py`, `cbahc.py`, `cbaac.py`, `png.py`) as
the coder's plain versions, which the tests hold byte-identical to it.

libdeflate (zlib-format streams, 2-4x faster than the zlib module, still
read by any standard inflate) is used by the PNG container when the
system has it, as the reference package does, so the PNG bytes match
on the same host.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_DIR = Path(__file__).resolve().parent
SRC = _DIR / "entropy.cpp"
BUILD_DIR = _DIR.parent / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_U8P = ctypes.POINTER(ctypes.c_uint8)
_U16P = ctypes.POINTER(ctypes.c_uint16)
_I64P = ctypes.POINTER(ctypes.c_int64)
_I64, _INT = ctypes.c_int64, ctypes.c_int
# C entry -> (restype, argtypes)
_SIGNATURES = {
    "vcf_huf_encode": (_I64, [_U16P, _I64, _U8P, _INT, _U8P, _I64]),
    "vcf_huf_decode": (_I64, [_U8P, _I64, _I64, _U8P, _INT, _U16P]),
    "vcf_hist8": (None, [_U8P, _I64, _I64P]),
    "vcf_huf_encode8": (_I64, [_U8P, _I64, _U8P, _U8P, _I64, _I64]),
    "vcf_huf_decode8": (_I64, [_U8P, _I64, _I64, _U8P, _U8P]),
    "vcf_rc_encode": (_I64, [_U8P, _I64, _INT, _U8P, _I64]),
    "vcf_rc_decode": (_I64, [_U8P, _I64, _I64, _INT, _U8P]),
    "vcf_cbahc_encode": (_I64, [_U8P, _I64, _INT, _U8P, _I64]),
    "vcf_cbahc_decode": (_I64, [_U8P, _I64, _I64, _INT, _U8P]),
    "vcf_png_unfilter": (_I64, [_U8P, _I64, _I64, _INT, _U8P]),
    "vcf_png_filter": (_I64, [_U8P, _I64, _I64, _INT, _U8P]),
}


def library_path() -> Path:
    """Where the library of the current source, flags and host lands."""
    h = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()
                       + platform.node().encode())
    return BUILD_DIR / f"libvcfentropy_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile entropy.cpp (if its library is not built yet); raise with
    the compiler's output if g++ is missing or fails."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to a temporary name and rename: concurrent processes (test
    # workers) never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, "-o", tmp, str(SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except FileNotFoundError as e:
        os.unlink(tmp)
        raise RuntimeError("native entropy coder: g++ not found") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"native entropy coder: g++ failed ({' '.join(cmd)}):\n"
            f"{proc.stderr}")
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The built library, building it on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def _u16p(a: np.ndarray):
    return a.ctypes.data_as(_U16P)


# ---------------------------------------------------------------------------
# Huffman
# ---------------------------------------------------------------------------

def hist8(flat: np.ndarray) -> np.ndarray:
    """Multi-threaded 256-bin histogram of a uint8 array."""
    syms = np.ascontiguousarray(flat, dtype=np.uint8)
    out = np.zeros(256, dtype=np.int64)
    load().vcf_hist8(_u8p(syms), syms.size, out.ctypes.data_as(_I64P))
    return out


def huffman_encode8(flat: np.ndarray, lengths: np.ndarray,
                    chunk_syms: int) -> bytes:
    """Chunked multi-threaded uint8 Huffman encode (self-framing payload)."""
    syms = np.ascontiguousarray(flat, dtype=np.uint8)
    lens = np.ascontiguousarray(lengths, dtype=np.uint8)
    max_len = int(lens.max()) if lens.size else 1
    n_chunks = (syms.size + chunk_syms - 1) // chunk_syms if syms.size else 0
    cap = syms.size * ((max_len + 7) // 8 + 1) + 8 * n_chunks + 64
    out = np.empty(cap, dtype=np.uint8)
    n = load().vcf_huf_encode8(_u8p(syms), syms.size, _u8p(lens), _u8p(out),
                               cap, chunk_syms)
    if n < 0:
        raise RuntimeError("native huffman encode8 failed")
    return out[:n].tobytes()


def huffman_decode8(payload: bytes, n_symbols: int,
                    lengths: np.ndarray) -> np.ndarray:
    lens = np.ascontiguousarray(lengths, dtype=np.uint8)
    src = np.frombuffer(payload, dtype=np.uint8)
    out = np.empty(n_symbols, dtype=np.uint8)
    n = load().vcf_huf_decode8(_u8p(src), src.size, n_symbols, _u8p(lens),
                               _u8p(out))
    if n != n_symbols:
        raise RuntimeError("native huffman decode8 failed")
    return out


def huffman_encode(flat: np.ndarray, lengths: np.ndarray) -> bytes:
    """Encode int symbols with the canonical codes of `lengths`."""
    syms = np.ascontiguousarray(flat, dtype=np.uint16)
    lens = np.ascontiguousarray(lengths, dtype=np.uint8)
    # capacity: worst case max_len bits per symbol
    max_len = int(lens.max()) if lens.size else 1
    cap = syms.size * ((max_len + 7) // 8 + 1) + 16
    out = np.empty(cap, dtype=np.uint8)
    n = load().vcf_huf_encode(_u16p(syms), syms.size, _u8p(lens), lens.size,
                              _u8p(out), cap)
    if n < 0:
        raise RuntimeError("native huffman encode failed")
    return out[:n].tobytes()


def huffman_decode(payload: bytes, n_symbols: int,
                   lengths: np.ndarray) -> np.ndarray:
    lens = np.ascontiguousarray(lengths, dtype=np.uint8)
    src = np.frombuffer(payload, dtype=np.uint8)
    out = np.empty(n_symbols, dtype=np.uint16)
    n = load().vcf_huf_decode(_u8p(src), src.size, n_symbols, _u8p(lens),
                              lens.size, _u16p(out))
    if n != n_symbols:
        raise RuntimeError("native huffman decode failed")
    return out


# ---------------------------------------------------------------------------
# Adaptive range coder (CBAAC)
# ---------------------------------------------------------------------------

def rc_encode(data: np.ndarray, order: int) -> bytes:
    syms = np.ascontiguousarray(data, dtype=np.uint8)
    cap = syms.size + (syms.size >> 1) + 1024
    out = np.empty(cap, dtype=np.uint8)
    n = load().vcf_rc_encode(_u8p(syms), syms.size, order, _u8p(out), cap)
    if n < 0:
        raise RuntimeError("native range-coder encode failed")
    return out[:n].tobytes()


def rc_decode(payload: bytes, n_symbols: int, order: int) -> np.ndarray:
    src = np.frombuffer(payload, dtype=np.uint8)
    out = np.empty(n_symbols, dtype=np.uint8)
    n = load().vcf_rc_decode(_u8p(src), src.size, n_symbols, order,
                             _u8p(out))
    if n != n_symbols:
        raise RuntimeError("native range-coder decode failed")
    return out


# ---------------------------------------------------------------------------
# Context-based adaptive Huffman (CBAHC)
# ---------------------------------------------------------------------------

def cbahc_encode(data: np.ndarray, order: int) -> bytes:
    syms = np.ascontiguousarray(data, dtype=np.uint8)
    cap = syms.size * 5 + 1024  # adaptive Huffman worst case < 32 bits/sym
    out = np.empty(cap, dtype=np.uint8)
    n = load().vcf_cbahc_encode(_u8p(syms), syms.size, order, _u8p(out), cap)
    if n < 0:
        raise RuntimeError("native cbahc encode failed")
    return out[:n].tobytes()


def cbahc_decode(payload: bytes, n_symbols: int, order: int) -> np.ndarray:
    src = np.frombuffer(payload, dtype=np.uint8)
    out = np.empty(n_symbols, dtype=np.uint8)
    n = load().vcf_cbahc_decode(_u8p(src), src.size, n_symbols, order,
                                _u8p(out))
    if n != n_symbols:
        raise RuntimeError("native cbahc decode failed")
    return out


# ---------------------------------------------------------------------------
# PNG scanline filters
# ---------------------------------------------------------------------------

def png_unfilter(data: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Reverse PNG per-scanline filters 0-4 (sequential hot loop)."""
    src = np.ascontiguousarray(data, dtype=np.uint8)
    out = np.empty((h, stride), dtype=np.uint8)
    n = load().vcf_png_unfilter(_u8p(src), h, stride, bpp, _u8p(out))
    if n != h:
        raise RuntimeError("native png unfilter failed")
    return out


def png_filter(raw: np.ndarray, bpp: int) -> bytes:
    """Adaptive per-row PNG filtering: one pass computes all five
    candidate costs, a second writes the winner."""
    src = np.ascontiguousarray(raw, dtype=np.uint8)
    h, stride = src.shape
    out = np.empty((h, stride + 1), dtype=np.uint8)
    n = load().vcf_png_filter(_u8p(src), h, stride, bpp, _u8p(out))
    if n != h:
        raise RuntimeError("native png filter failed")
    return out.tobytes()


# ---------------------------------------------------------------------------
# libdeflate, when the system has it
# ---------------------------------------------------------------------------

_DEFLATE_NAMES = ("libdeflate.so.0", "libdeflate.so")
_deflate_lib = None
_deflate_tried = False
_deflate_lock = threading.Lock()
# libdeflate (de)compressor objects are single-thread use: one per
# (thread, level)
_deflate_tls = threading.local()


def _load_deflate():
    global _deflate_lib, _deflate_tried
    with _deflate_lock:
        if _deflate_lib is not None or _deflate_tried:
            return _deflate_lib
        _deflate_tried = True
        for name in _DEFLATE_NAMES:
            try:
                lib = ctypes.CDLL(name)
            except OSError:
                continue
            vp, sz = ctypes.c_void_p, ctypes.c_size_t
            lib.libdeflate_alloc_compressor.restype = vp
            lib.libdeflate_alloc_compressor.argtypes = [ctypes.c_int]
            lib.libdeflate_alloc_decompressor.restype = vp
            lib.libdeflate_alloc_decompressor.argtypes = []
            lib.libdeflate_zlib_compress.restype = sz
            lib.libdeflate_zlib_compress.argtypes = [vp, vp, sz, vp, sz]
            lib.libdeflate_zlib_compress_bound.restype = sz
            lib.libdeflate_zlib_compress_bound.argtypes = [vp, sz]
            lib.libdeflate_zlib_decompress.restype = ctypes.c_int
            lib.libdeflate_zlib_decompress.argtypes = [
                vp, vp, sz, vp, sz, ctypes.POINTER(sz)]
            _deflate_lib = lib
            break
        return _deflate_lib


def deflate_available() -> bool:
    return _load_deflate() is not None


def zlib_compress(data: bytes, level: int = 6) -> bytes:
    """zlib-format compress via libdeflate (levels 1-12)."""
    lib = _load_deflate()
    level = min(max(level, 1), 12)
    comps = getattr(_deflate_tls, "comps", None)
    if comps is None:
        comps = _deflate_tls.comps = {}
    comp = comps.get(level)
    if comp is None:
        comp = comps[level] = lib.libdeflate_alloc_compressor(level)
    cap = lib.libdeflate_zlib_compress_bound(comp, len(data))
    out = ctypes.create_string_buffer(cap)
    n = lib.libdeflate_zlib_compress(comp, data, len(data), out, cap)
    if n == 0:
        raise RuntimeError("libdeflate compress failed")
    return out.raw[:n]


def zlib_decompress(data: bytes, out_size: int) -> bytes:
    """zlib-format decompress via libdeflate (exact output size known)."""
    lib = _load_deflate()
    decomp = getattr(_deflate_tls, "decomp", None)
    if decomp is None:
        decomp = _deflate_tls.decomp = lib.libdeflate_alloc_decompressor()
    out = ctypes.create_string_buffer(out_size)
    actual = ctypes.c_size_t(0)
    rc = lib.libdeflate_zlib_decompress(
        decomp, data, len(data), out, out_size, ctypes.byref(actual))
    if rc != 0:
        raise RuntimeError(f"libdeflate decompress failed rc={rc}")
    return out.raw[: actual.value]
