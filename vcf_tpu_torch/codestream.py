"""Codestream container and byte accounting.

The reference exchanges stage state through files under /tmp: the main
codestream plus named sidecar files (shape structs, Huffman trees,
centroid archives, ...), and rate is the summed size of every
`/tmp/encoded*` file (reference: src/RDE.py:91-99, SURVEY §1
"File-based inter-stage protocol").

Here a `CodeStream` is an in-memory container: an ordered mapping of
named byte segments.  `total_bytes` reproduces VCF's rate accounting
(payload + all sidecars).  `to_file`/`from_file` serialize the whole
container into a single file with a tiny TLV header, and
`write_vcf_layout` writes the segments as separate files the way the
reference does (payload at `{prefix}`, sidecars at `{prefix}_{name}`),
so on-disk layouts can be compared against the reference's.
"""

from __future__ import annotations

import io
import json
import struct
from collections import OrderedDict
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

_MAGIC = b"VCFT"
_VERSION = 1

# Segment name of the main payload (the `/tmp/encoded` file in VCF terms).
PAYLOAD = "payload"


class CodeStream:
    """Ordered named byte segments + JSON-able metadata."""

    def __init__(self) -> None:
        self._segments: "OrderedDict[str, bytes]" = OrderedDict()
        self.meta: Dict = {}

    # ---- segment access --------------------------------------------------
    def __setitem__(self, name: str, data: bytes) -> None:
        if not isinstance(data, (bytes, bytearray, memoryview)):
            raise TypeError(f"segment {name!r} must be bytes, got {type(data)}")
        self._segments[name] = bytes(data)

    def __getitem__(self, name: str) -> bytes:
        return self._segments[name]

    def __contains__(self, name: str) -> bool:
        return name in self._segments

    def __iter__(self) -> Iterator[str]:
        return iter(self._segments)

    def get(self, name: str, default: Optional[bytes] = None) -> Optional[bytes]:
        return self._segments.get(name, default)

    def items(self) -> Iterator[Tuple[str, bytes]]:
        return iter(self._segments.items())

    @property
    def payload(self) -> bytes:
        return self._segments[PAYLOAD]

    @payload.setter
    def payload(self, data: bytes) -> None:
        self[PAYLOAD] = data

    # ---- rate accounting (VCF parity: src/RDE.py:91-99) ------------------
    @property
    def total_bytes(self) -> int:
        return sum(len(v) for v in self._segments.values())

    def bpp(self, shape: Tuple[int, ...]) -> float:
        """Bits per pixel over H*W (*N_frames); reference: src/RDE.py:100-104."""
        n_pixels = int(np.prod([s for s in shape[:2]])) * (
            int(shape[3]) if len(shape) > 3 else 1
        )
        return self.total_bytes * 8.0 / n_pixels

    # ---- numpy helpers ---------------------------------------------------
    def put_array(self, name: str, arr: np.ndarray) -> None:
        """Store an ndarray segment (uncompressed .npy bytes)."""
        buf = io.BytesIO()
        np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
        self[name] = buf.getvalue()

    def get_array(self, name: str) -> np.ndarray:
        return np.load(io.BytesIO(self._segments[name]), allow_pickle=False)

    def put_shape(self, shape: Tuple[int, ...], name: str = "shape") -> None:
        """VCF stores the pre-pad image shape as struct 'iii'
        (reference: src/2D-DCT.py:285-287)."""
        self[name] = struct.pack(f"{len(shape)}i", *shape)

    def get_shape(self, ndim: int = 3, name: str = "shape") -> Tuple[int, ...]:
        return struct.unpack(f"{ndim}i", self._segments[name])

    def put_json(self, name: str, obj) -> None:
        self[name] = json.dumps(obj, sort_keys=True).encode("utf-8")

    def get_json(self, name: str):
        return json.loads(self._segments[name].decode("utf-8"))

    # ---- serialization ---------------------------------------------------
    def to_bytes(self) -> bytes:
        """Single-blob serialization: MAGIC, version, meta JSON, then
        length-prefixed (name, data) records."""
        out = io.BytesIO()
        meta_blob = json.dumps(self.meta, sort_keys=True).encode("utf-8")
        out.write(_MAGIC)
        out.write(struct.pack("<HI", _VERSION, len(meta_blob)))
        out.write(meta_blob)
        out.write(struct.pack("<I", len(self._segments)))
        for name, data in self._segments.items():
            nb = name.encode("utf-8")
            out.write(struct.pack("<HQ", len(nb), len(data)))
            out.write(nb)
            out.write(data)
        return out.getvalue()

    @classmethod
    def from_bytes(cls, blob: bytes) -> "CodeStream":
        buf = io.BytesIO(blob)
        if buf.read(4) != _MAGIC:
            raise ValueError("not a vcf_tpu codestream")
        version, meta_len = struct.unpack("<HI", buf.read(6))
        if version != _VERSION:
            raise ValueError(f"unsupported codestream version {version}")
        cs = cls()
        cs.meta = json.loads(buf.read(meta_len).decode("utf-8"))
        (n_segments,) = struct.unpack("<I", buf.read(4))
        for _ in range(n_segments):
            name_len, data_len = struct.unpack("<HQ", buf.read(10))
            name = buf.read(name_len).decode("utf-8")
            cs[name] = buf.read(data_len)
        return cs

    def to_file(self, path: str) -> int:
        blob = self.to_bytes()
        with open(path, "wb") as f:
            f.write(blob)
        return len(blob)

    @classmethod
    def from_file(cls, path: str) -> "CodeStream":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read())

    # ---- VCF on-disk layout ---------------------------------------------
    def write_vcf_layout(self, prefix: str) -> int:
        """Write payload to `{prefix}` and each sidecar to
        `{prefix}_{name}`, mirroring the reference's /tmp file layout."""
        total = 0
        for name, data in self._segments.items():
            path = prefix if name == PAYLOAD else f"{prefix}_{name}"
            with open(path, "wb") as f:
                f.write(data)
            total += len(data)
        return total

    @classmethod
    def read_vcf_layout(cls, prefix: str) -> "CodeStream":
        """Read a codestream written with `write_vcf_layout`: payload at
        `{prefix}`, sidecars globbed from `{prefix}_*` (the reference's
        RDE sums the same glob, src/RDE.py:91-99)."""
        import glob
        import os

        cs = cls()
        with open(prefix, "rb") as f:
            cs[PAYLOAD] = f.read()
        for path in sorted(glob.glob(prefix + "_*")):
            name = os.path.basename(path)[len(os.path.basename(prefix)) + 1 :]
            with open(path, "rb") as f:
                cs[name] = f.read()
        return cs

    def __repr__(self) -> str:
        segs = ", ".join(f"{k}:{len(v)}B" for k, v in self._segments.items())
        return f"CodeStream({segs}; total={self.total_bytes}B)"
