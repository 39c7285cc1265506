"""PNM (netpbm) "fake" codec — uncompressed rate upper bound (port of
vcf_tpu/entropy/pnm.py).

Capability parity with src/PNM.py (netpbmfile-backed in the reference).
P5 (gray) / P6 (RGB), maxval 255 (uint8) or 65535 (uint16, big-endian
samples per the netpbm spec).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from vcf_tpu_torch.entropy.base import EntropyCodec


class PNMCodec(EntropyCodec):
    file_extension = ".pnm"

    def encode(self, arr: np.ndarray) -> Tuple[bytes, Dict[str, bytes]]:
        arr = self.check_dtype(arr)
        if arr.ndim == 3 and arr.shape[2] == 3:
            magic = b"P6"
        elif arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] == 1):
            magic = b"P5"
            arr = arr.reshape(arr.shape[0], arr.shape[1])
        else:
            raise ValueError(f"unsupported PNM shape {arr.shape}")
        maxval = 255 if arr.dtype == np.uint8 else 65535
        header = b"%s\n%d %d\n%d\n" % (magic, arr.shape[1], arr.shape[0], maxval)
        data = arr.astype(">u2").tobytes() if maxval == 65535 else arr.tobytes()
        return header + data, {}

    def decode(self, payload: bytes, side: Dict[str, bytes]) -> np.ndarray:
        # parse header: magic, whitespace/comment-separated tokens
        tokens = []
        pos = 0
        while len(tokens) < 4:
            # skip whitespace and comments
            while pos < len(payload) and payload[pos : pos + 1].isspace():
                pos += 1
            if payload[pos : pos + 1] == b"#":
                while pos < len(payload) and payload[pos : pos + 1] != b"\n":
                    pos += 1
                continue
            start = pos
            while pos < len(payload) and not payload[pos : pos + 1].isspace():
                pos += 1
            tokens.append(payload[start:pos])
        pos += 1  # single whitespace after maxval
        magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
        channels = 3 if magic == b"P6" else 1
        dtype = np.dtype(">u2") if maxval > 255 else np.dtype(np.uint8)
        count = w * h * channels
        arr = np.frombuffer(payload, dtype=dtype, count=count, offset=pos)
        arr = arr.astype(np.uint16 if maxval > 255 else np.uint8)
        shape = (h, w, 3) if channels == 3 else (h, w)
        return arr.reshape(shape).copy()
