"""Entropy codecs (port of vcf_tpu/entropy; the ported part).

Each codec turns a uint8/uint16 index array into bytes and back, with
the same bytes as vcf_tpu's codec of the same name:

    payload, side = codec.encode(arr)      # arr: np.uint8 | np.uint16
    arr = codec.decode(payload, side)

`tiff`, `zlib`, `pnm` and `png` are host numpy; `huffman`, `cbahc` and
`cbaac` run their loops in the port's native host coder
(`vcf_tpu_torch.native`, built with g++ on first use; a failed build
raises).  `rans`, `grans`, `cgrans` and `srans` run on a torch device
that the caller names; on CUDA they launch the rANS kernels.  `ihuff`
runs as torch ops on the named device.
"""

from __future__ import annotations

import torch

from vcf_tpu_torch.entropy.base import EntropyCodec
from vcf_tpu_torch.entropy.cbaac import CBAACCodec
from vcf_tpu_torch.entropy.cbahc import CBAHCCodec
from vcf_tpu_torch.entropy.huffman import HuffmanCodec
from vcf_tpu_torch.entropy.interleaved import InterleavedHuffmanCodec
from vcf_tpu_torch.entropy.png import PNGCodec
from vcf_tpu_torch.entropy.pnm import PNMCodec
from vcf_tpu_torch.entropy.rans import (CtxRANSCodec, GroupedRANSCodec,
                                        RANSCodec, SparseRANSCodec)
from vcf_tpu_torch.entropy.tiff import TIFFCodec
from vcf_tpu_torch.entropy.zlib_codec import ZlibCodec

_HOST = {"zlib": ZlibCodec, "tiff": TIFFCodec, "pnm": PNMCodec,
         "png": PNGCodec, "huffman": HuffmanCodec, "cbahc": CBAHCCodec,
         "cbaac": CBAACCodec}
_ON_DEVICE = {"rans": RANSCodec, "grans": GroupedRANSCodec,
              "cgrans": CtxRANSCodec, "srans": SparseRANSCodec,
              "ihuff": InterleavedHuffmanCodec}


def get(name: str, config=None, device=None) -> EntropyCodec:
    """Instantiate an entropy codec by config name; `device` (a torch
    device) is required by the codecs that run on one."""
    if name in _HOST:
        return _HOST[name].from_config(config)
    if name in _ON_DEVICE:
        if device is None:
            raise ValueError(f"entropy codec {name!r} needs a torch device")
        return _ON_DEVICE[name].from_config(config, device=torch.device(device))
    raise KeyError(f"unknown entropy codec {name!r}")


__all__ = ["EntropyCodec", "get", "CBAACCodec", "CBAHCCodec",
           "CtxRANSCodec", "GroupedRANSCodec", "HuffmanCodec",
           "InterleavedHuffmanCodec", "PNGCodec", "PNMCodec", "RANSCodec",
           "SparseRANSCodec", "TIFFCodec", "ZlibCodec"]
