"""Grouped-rANS entropy of the DWT flow on the device (port of
vcf_tpu/entropy/dwt_device.py).

Every subband becomes one rANS GROUP with its own table (the per-band
statistics of the reference's per-band streams, src/2D-DWT.py:162-200);
the 16-bit LL band becomes two groups (high and low byte planes).  All
groups get the same lane count `sg`; short bands pad with 128, the
deadzone zero, whose cost under the band's own table is ~0 bits.  The
lanes are lane-major: lane j codes the contiguous raster span
[j * L, (j + 1) * L) of its band, so a lane's previous symbol is the
spatially adjacent coefficient, the context of the order-1 tables.

A clip of N frames (`ops.dwt.DWT.clip_to_lanes`) keeps one frame's lane
grid shape and stacks the frames inside each group: group i holds band
i's lanes of frame 0, then of frame 1, ... (`bands_to_grid`), so the
grid is (G * sg * N, L) and one frame is the still codec's grid.

Order 0 runs K1 + K2 and K3; the order-1 context tables (`cgrans`) run
the context modes of K1 and K3 with K2 (`entropy.rans`).  A clip's
stream stays on the device: `entropy.rans.encode_lanes_device` is the
encode's device half (words, n_words, states and counts), which
`encode_grid` copies to the host.  The lane grid
follows vcf_tpu's non-TPU rule (power-of-two sg, L a multiple of 4),
which is what vcf_tpu writes on the CPU; a decoder reads sg and L from
the sidecar.

Wire format (sidecar ``gdwt_model``): u8 version | u32 G | u32 sg |
u32 L | u32 n_words | u32 qss | [u8 n_ctx, version 2] | states (S u32)
| u32 counts_zlib_len | zlib(u32 per-step renorm counts) | zlib(u16
freqs[G*256] or [G*n_ctx*256]).
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Sequence, Tuple

import numpy as np
import torch

from vcf_tpu_torch.entropy import rans as rans_mod
from vcf_tpu_torch.utils import profiling


def grid_dims(band_sizes: Sequence[int],
              syms_per_lane: int = 512) -> Tuple[int, int]:
    """(sg, L) of the uniform lane grid: sg the largest power of two at
    or below ~`syms_per_lane` symbols per lane over the whole image (the
    RANSCodec._pick_streams rule), at least 8; L covers the largest band,
    rounded up to a multiple of 4."""
    n_total = sum(band_sizes)
    n_max = max(band_sizes)
    g = len(band_sizes)
    target = max(8, n_total // syms_per_lane // g)
    sg = 1 << int(np.floor(np.log2(target)))
    l = -(-n_max // sg)
    return sg, -(-l // 4) * 4


def bands_to_grid(bands_u8: List[torch.Tensor], sg: int, l: int,
                  frames: int = 1) -> torch.Tensor:
    """List of u8 bands, each of `frames` frames ((frames, ...) in frame
    order; any shape for one frame) -> the (G * sg * frames, L) grouped
    lane grid: group i holds band i's (sg, L) lane block of frame 0, then
    of frame 1, ..., where lane j of a frame's block codes its band's
    flat[j*L : (j+1)*L], padded with 128 (the deadzone zero).  One frame
    is the still codec's grid.  The symbols are copied once into a grid
    whose padding alone is filled, in a `vcf.dwt.layout` span, the bytes
    read and written counted in `layout_bytes`."""
    g = len(bands_u8)
    with profiling.span("vcf.dwt.layout"):
        grid = torch.empty((g, frames, sg * l), dtype=torch.uint8,
                           device=bands_u8[0].device)
        for block, band in zip(grid, bands_u8):
            n = band.numel() // frames
            block[:, :n] = band.reshape(frames, n)
            block[:, n:] = 128
    profiling.count("layout_bytes",
                    sum(b.numel() for b in bands_u8) + grid.numel())
    return grid.view(g * frames * sg, l)


def grid_to_bands(lanes: torch.Tensor, sizes: Sequence[int], sg: int,
                  frames: int = None) -> List[torch.Tensor]:
    """(G * sg * frames, L) grid -> the first sizes[i] symbols of each
    group's block of each frame: (frames, sizes[i]) views, or (sizes[i],)
    of a one-frame grid where `frames` is not given.  A grid that is not
    contiguous (K3 returns a transposed view) is copied once first, in a
    `vcf.dwt.layout` span, its bytes counted in `layout_bytes`."""
    if not lanes.is_contiguous():
        with profiling.span("vcf.dwt.layout"):
            lanes = lanes.contiguous()
        profiling.count("layout_bytes", 2 * lanes.nbytes)
    blocks = lanes.view(len(sizes), frames or 1, -1)
    bands = [block[:, :n] for block, n in zip(blocks, sizes)]
    return bands if frames else [b[0] for b in bands]


def train_tables(lanes: torch.Tensor, g: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-group quantized (freqs, cums), (G, 256) uint32, from the data
    itself (padding included)."""
    return rans_mod.freqs_from_counts(
        rans_mod.group_histograms(lanes, g).cpu().numpy())


def train_ctx_tables(lanes: torch.Tensor, g: int,
                     n_ctx: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-(group, class) quantized tables, (G, n_ctx, 256) uint32."""
    return rans_mod.ctx_freqs_from_counts(
        rans_mod.ctx_group_histograms(lanes, g, n_ctx).cpu().numpy())


def encode_grid(lanes: torch.Tensor, fg: np.ndarray, cg: np.ndarray):
    """(S, L) u8 lanes -> (words u16, n_words, states u32, counts int64);
    (G, 256) tables code order 0, (G, n_ctx, 256) tables order 1."""
    payload, n_words, counts, states = rans_mod._encode_lanes(lanes, fg, cg)
    return (rans_mod._wire_words(payload, n_words), n_words, states,
            counts.astype(np.int64))


def decode_grid(words: np.ndarray, states: np.ndarray, counts: np.ndarray,
                fg: np.ndarray, cg: np.ndarray, l: int,
                device) -> torch.Tensor:
    """Inverse of encode_grid -> (S, L) u8 lanes on `device`."""
    return rans_mod._decode_lanes(words, states, fg, cg, l, counts,
                                  torch.device(device))


# ---------------------------------------------------------------------------
# Sidecar serialization
# ---------------------------------------------------------------------------

def pack_model(g: int, sg: int, l: int, n_words: int, qss: int,
               states: np.ndarray, counts: np.ndarray,
               fg: np.ndarray, n_ctx: int = 0) -> bytes:
    """n_ctx == 0: order-0 (version 1, fg (G, 256)); n_ctx > 0:
    order-1 context (version 2, fg (G, n_ctx, 256))."""
    counts_z = zlib.compress(counts.astype("<u4").tobytes(), 6)
    ver = 2 if n_ctx else 1
    head = struct.pack("<BIIIII", ver, g, sg, l, n_words, qss)
    if n_ctx:
        head += struct.pack("<B", n_ctx)
    return (head
            + states.astype("<u4").tobytes()
            + struct.pack("<I", len(counts_z)) + counts_z
            + zlib.compress(fg.astype("<u2").tobytes(), 9))


def unpack_model(blob: bytes):
    ver, g, sg, l, n_words, qss = struct.unpack_from("<BIIIII", blob, 0)
    if ver not in (1, 2):
        raise ValueError(f"gdwt_model version {ver}")
    off = 21
    n_ctx = 0
    if ver == 2:
        (n_ctx,) = struct.unpack_from("<B", blob, off)
        off += 1
    s = g * sg
    states = np.frombuffer(blob, "<u4", s, off).copy()
    off += 4 * s
    (clen,) = struct.unpack_from("<I", blob, off)
    off += 4
    counts = np.frombuffer(zlib.decompress(blob[off:off + clen]), "<u4"
                           ).astype(np.int64)
    off += clen
    raw = np.frombuffer(zlib.decompress(blob[off:]), "<u2"
                        ).astype(np.uint32)
    fg = raw.reshape(g, max(n_ctx, 1), 256)
    cg = rans_mod.ctx_cums(fg)
    if not n_ctx:
        fg, cg = fg[:, 0], cg[:, 0]
    return g, sg, l, n_words, qss, states, counts, fg, cg, n_ctx
