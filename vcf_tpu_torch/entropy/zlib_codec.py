"""zlib (DEFLATE) entropy codec.

Capability parity with the reference's z_lib stage
(src/z_lib.py:19-29: np.savez_compressed / np.load).  We serialize a
minimal header (dtype code, ndim, dims) + DEFLATE of the raw array
bytes — same underlying compressor as the .npz container without the
ZIP framing, so compressed sizes are <= the reference's for identical
data.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

from vcf_tpu_torch.entropy.base import EntropyCodec

_DTYPES = {0: np.uint8, 1: np.uint16}
_CODES = {np.dtype(np.uint8): 0, np.dtype(np.uint16): 1}


class ZlibCodec(EntropyCodec):
    file_extension = ".npz"

    def __init__(self, level: int = 6):
        self.level = level

    @classmethod
    def from_config(cls, config=None):
        return cls(level=getattr(config, "zlib_level", 6))

    def encode(self, arr: np.ndarray) -> Tuple[bytes, Dict[str, bytes]]:
        arr = self.check_dtype(arr)
        header = struct.pack(
            f"<BB{arr.ndim}I", _CODES[arr.dtype], arr.ndim, *arr.shape
        )
        return header + zlib.compress(arr.tobytes(), self.level), {}

    def decode(self, payload: bytes, side: Dict[str, bytes]) -> np.ndarray:
        code, ndim = struct.unpack_from("<BB", payload, 0)
        shape = struct.unpack_from(f"<{ndim}I", payload, 2)
        data = zlib.decompress(payload[2 + 4 * ndim :])
        return np.frombuffer(data, dtype=_DTYPES[code]).reshape(shape).copy()
