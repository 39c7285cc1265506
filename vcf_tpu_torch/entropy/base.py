"""Entropy codec interface."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Tuple

import numpy as np


class EntropyCodec:
    """Lossless array <-> bytes codec.

    Equivalent of the reference's L2 entropy layer contract:
    ``compress(np.uint8/16 array) -> stream`` / ``decompress -> array``
    (SURVEY §1 L2; e.g. src/TIFF.py:23-39).
    """

    #: file extension for VCF-layout output (e.g. ".tif", ".png")
    file_extension = ".bin"

    @classmethod
    def from_config(cls, config=None) -> "EntropyCodec":
        return cls()

    def encode(self, arr: np.ndarray) -> Tuple[bytes, Dict[str, bytes]]:
        raise NotImplementedError

    def decode(self, payload: bytes, side: Dict[str, bytes]) -> np.ndarray:
        raise NotImplementedError

    # ---- batch (frame-parallel) API --------------------------------------
    # Host containers release the GIL in their hot loops (native C++,
    # zlib/libdeflate), so a thread pool across frames is a real ~Nx on
    # an N-core host.  Streams are byte-identical to per-frame encode.
    # Reference role: the per-frame process-level parallelism a user of
    # VCF gets from running one process per image (SURVEY §2.4).

    def encode_batch(self, arrs: Sequence[np.ndarray]
                     ) -> List[Tuple[bytes, Dict[str, bytes]]]:
        if len(arrs) <= 1:
            return [self.encode(a) for a in arrs]
        with ThreadPoolExecutor(min(len(arrs), os.cpu_count() or 1)) as ex:
            return list(ex.map(self.encode, arrs))

    def decode_batch(self, items: Sequence[Tuple[bytes, Dict[str, bytes]]]
                     ) -> List[np.ndarray]:
        if len(items) <= 1:
            return [self.decode(p, s) for p, s in items]
        with ThreadPoolExecutor(min(len(items), os.cpu_count() or 1)) as ex:
            return list(ex.map(lambda it: self.decode(it[0], it[1]), items))

    # ---- helpers ---------------------------------------------------------
    @staticmethod
    def check_dtype(arr: np.ndarray) -> np.ndarray:
        """The reference's entropy codecs assert uint8/uint16 input
        (src/TIFF.py:26, src/PNG.py:27, src/PNM.py:24)."""
        if arr.dtype not in (np.uint8, np.uint16):
            raise TypeError(f"entropy codec input must be uint8/uint16, got {arr.dtype}")
        return np.ascontiguousarray(arr)
