"""Order-1 context rANS kernels (port of vcf_tpu/ops/pallas/rans_ctx.py).

`rans_encode_ctx` replaces `pallas_encode_ctx_raw` and
`pallas_encode_ctx_raw_u8` (one output, two TPU input layouts): syms
(S, L) u8, lane s on group s // (S // G), and each symbol coded with the
table of (group, class of the lane's previous symbol) -> the raw grid
(L, S) int32 and the final states, K1's contract.  Its words go through
K2 `rans_compact` unchanged.  It is the context mode of K1's kernel.
`rans_decode_ctx` replaces `pallas_decode_ctx` and its pre-pass
`build_windows`: the wire words -> (S, L) u8, K3's contract and error
codes, the class taken from the symbol the lane decoded one step before.
It is the context mode of K3's two kernels (look-back with counts, one
block without).  `rans_decode_ctx_grid` replaces
`pallas_decode_ctx_grid`: the routing-free decode straight from the
encoder's raw (L, S) grid (as `rans_decode_grouped_grid`), the class
carried per lane.  Design notes and bounds are in csrc/rans_encode.cu,
csrc/rans_decode.cu and csrc/rans_grid.cu.

The class of a previous symbol p is #{b in CTX_BOUNDS[n_ctx] : |p - 128|
>= b}; the first symbol of a lane takes the class of 128, which is 0.
Tables are (G, n_ctx, 256) freqs and their exclusive prefix sums; every
row sums to 2^15.

Each wrapper runs the plain torch version for a CPU tensor and launches
its CUDA kernel for a CUDA tensor; nothing else.  `launches` counts the
kernel launches.  Spans (`utils.profiling`), as the order-0 wrappers
have them: `vcf.rans.encode` around the encode, with K1's (L, S) copy in
`vcf.rans.layout` (its bytes counted in `layout_bytes`), and
`vcf.rans.decode` around both decodes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from vcf_tpu_torch.ops.cuda import _build
from vcf_tpu_torch.ops.cuda.rans_decode import (
    check_grid, decode_steps_ref, grid_steps_ref, launch_decode,
    launch_grid, raise_decode_error)
from vcf_tpu_torch.ops.cuda.rans_encode import (
    K_PROB, _require, _require_cuda, _steps_major, encode_steps_ref,
    i32_as_u32, launch_encode, pack_tables, to_host)
from vcf_tpu_torch.utils import profiling

N_CTX = 4

#: |prev - 128| class thresholds per class count: class = #{b : d >= b}.
#: 4 is the speed point, 15 the rate-priority point.
CTX_BOUNDS = {
    4: (1, 2, 5),
    15: (1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97),
}


def class_lut(n_ctx: int) -> np.ndarray:
    """(256,) uint8: the context class of every previous symbol."""
    if n_ctx not in CTX_BOUNDS:
        raise ValueError(f"n_ctx must be one of {sorted(CTX_BOUNDS)}, "
                         f"got {n_ctx}")
    d = np.abs(np.arange(256) - 128)
    return (d[:, None] >= np.asarray(CTX_BOUNDS[n_ctx])[None, :]
            ).sum(axis=1).astype(np.uint8)


_LUTS: dict = {}


def class_lut_on(n_ctx: int, device, dtype=torch.uint8) -> torch.Tensor:
    """`class_lut(n_ctx)` as a tensor of `dtype` on `device`, made once per
    (n_ctx, device, dtype) and shared: callers only read it."""
    key = (n_ctx, torch.device(device), dtype)
    if key not in _LUTS:
        _LUTS[key] = torch.from_numpy(class_lut(n_ctx)).to(device, dtype)
    return _LUTS[key]


def _check_tables(freqs_gc, cums_gc) -> Tuple[torch.Tensor, torch.Tensor]:
    """(G, n_ctx, 256) tables as int64; raise unless every row sums to
    2^15 and cums is the exclusive prefix sum of freqs (the kernels read
    f from the cumulative rows)."""
    f = torch.as_tensor(freqs_gc).to(torch.int64)
    c = torch.as_tensor(cums_gc).to(torch.int64)
    _require(f.dim() == 3 and f.shape[2] == 256 and f.shape == c.shape,
             f"context tables must be (G, n_ctx, 256), got {tuple(f.shape)} "
             f"and {tuple(c.shape)}")
    _require(f.shape[1] in CTX_BOUNDS,
             f"n_ctx must be one of {sorted(CTX_BOUNDS)}, got {f.shape[1]}")
    # both checks come back in one readback
    sums_ok, prefix_ok = to_host(torch.stack([
        (f.sum(dim=2) == 1 << K_PROB).all(),
        (c[..., 0] == 0).all()
        & (c[..., 1:] == torch.cumsum(f, dim=2)[..., :-1]).all()])).tolist()
    _require(sums_ok, f"every context table's freqs must sum to 2^{K_PROB}")
    _require(prefix_ok, "cums_gc is not the exclusive prefix sum of freqs_gc")
    return f, c


def _groups(s_streams: int, g: int, device) -> torch.Tensor:
    """The group of every lane; raise unless the lanes split into g."""
    _require(g >= 1 and s_streams % g == 0,
             f"{s_streams} lanes do not split into {g} groups")
    return torch.arange(s_streams, device=device) // (s_streams // g)


# ---------------------------------------------------------------------------
# Encode: the context mode of K1
# ---------------------------------------------------------------------------

def rans_encode_ctx_ref(syms: torch.Tensor, freqs_gc, cums_gc
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch context encode: every symbol's (group, class, symbol)
    entry gathered at once, then K1's int64 step loop.  Returns (raw
    (L, S) int32, states (S,) int64)."""
    dev = syms.device
    f, c = _check_tables(freqs_gc, cums_gc)
    g, n_ctx = f.shape[:2]
    grp = _groups(syms.shape[0], g, dev)
    lut = class_lut_on(n_ctx, dev, torch.int64)
    sym_l = syms.t().to(torch.int64)                         # (L, S)
    prev = torch.cat([torch.full_like(sym_l[:1], 128), sym_l[:-1]])
    idx = ((grp[None, :] * n_ctx + lut[prev]) << 8) + sym_l
    return encode_steps_ref(f.to(dev).reshape(-1)[idx],
                            c.to(dev).reshape(-1)[idx])


def rans_encode_ctx(syms: torch.Tensor, freqs_gc, cums_gc
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """syms (S, L) uint8, lane s on group s // (S // G); freqs_gc/cums_gc
    (G, n_ctx, 256).  Returns (raw (L, S) int32 with (emit << 16) | low16
    per decode step, final states (S,) int64 in [0, 2^32))."""
    _require(syms.dim() == 2 and syms.dtype == torch.uint8,
             f"syms must be (S, L) uint8, got {syms.dtype} {tuple(syms.shape)}")
    with profiling.span("vcf.rans.encode"):
        if syms.device.type == "cpu":
            return rans_encode_ctx_ref(syms, freqs_gc, cums_gc)
        _require_cuda(syms)
        f, c = _check_tables(freqs_gc, cums_gc)
        g, n_ctx = f.shape[:2]
        s_streams = syms.shape[0]
        _require(s_streams % g == 0, f"{s_streams} lanes do not split into "
                 f"{g} groups")
        dev = syms.device
        tab = pack_tables(f.reshape(g * n_ctx, 256),
                          c.reshape(g * n_ctx, 256), dev)
        lut = class_lut_on(n_ctx, dev)
        raw, states = launch_encode(_steps_major(syms), tab, lut, g, n_ctx)
        rans_encode_ctx.launches += 1
        return raw, i32_as_u32(states)


rans_encode_ctx.launches = 0


# ---------------------------------------------------------------------------
# Decode: the context mode of K3
# ---------------------------------------------------------------------------

def rans_decode_ctx_ref(words: torch.Tensor, states: torch.Tensor,
                        freqs_gc, cums_gc, l: int,
                        counts: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Plain torch context decode: K3's step loop, each step's symbols
    found by ONE searchsorted over the flattened (G * n_ctx * 256)
    cumulative table, row r offset by r * 2^15 so that it is sorted
    (O(S log(G * n_ctx * 256)) a step).  Returns syms (S, L) uint8."""
    resolve = _ctx_resolver(freqs_gc, cums_gc, states.shape[0], words.device)
    return decode_steps_ref(words, states, l, counts, resolve)


def _ctx_resolver(freqs_gc, cums_gc, s_streams: int, dev):
    """The plain context decodes' `resolve(slot)`: every lane's (symbol,
    f, cum) at the next step, the class taken from the symbol it resolved
    one call before (128, class 0, at the first call)."""
    f, c = _check_tables(freqs_gc, cums_gc)
    g, n_ctx = f.shape[:2]
    grp = _groups(s_streams, g, dev)
    lut = class_lut_on(n_ctx, dev, torch.int64)
    f_flat = f.to(dev).reshape(-1)
    rows = torch.arange(g * n_ctx, device=dev)
    c_flat = c.to(dev).reshape(g * n_ctx, 256)
    keys = (c_flat + (rows[:, None] << K_PROB)).reshape(-1)
    c_flat = c_flat.reshape(-1)
    prev = torch.full_like(grp, 128)

    def resolve(slot):
        nonlocal prev
        row = grp * n_ctx + lut[prev]
        idx = torch.searchsorted(keys, (row << K_PROB) + slot, right=True) - 1
        prev = idx - (row << 8)
        return prev, f_flat[idx], c_flat[idx]

    return resolve


def cum_rows(f: torch.Tensor, c: torch.Tensor, device) -> torch.Tensor:
    """(G, n_ctx, 256) checked tables -> the decode kernel's rows: 257
    uint16 cumulative entries per (group, class), the row total last,
    flattened and padded to an even count (the kernel copies u32 words)."""
    total = (c[..., -1:] + f[..., -1:])
    rows = torch.cat([c, total], dim=2).reshape(-1)
    rows = torch.cat([rows, rows.new_zeros(rows.numel() % 2)])
    return rows.to(torch.int32).to(torch.uint16).to(device).contiguous()


def decode_table_mode(s_streams: int, g: int, n_ctx: int,
                      counts: bool = True) -> str:
    """Where the context decode keeps (G, n_ctx) tables for S lanes:
    "shared" memory or "global" memory (read through L1/L2).  With counts
    (the look-back kernel) a block holds the rows of the groups its lanes
    span; without (the one-block kernel) all G groups' rows."""
    lib = _build.load()
    fits = (lib.vcf_rans_decode_lookback_smem(s_streams, g, n_ctx) if counts
            else lib.vcf_rans_decode_ctx_smem(g, n_ctx))
    return "shared" if fits else "global"


def rans_decode_ctx(words: torch.Tensor, states: torch.Tensor,
                    freqs_gc, cums_gc, l: int,
                    counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """words (n_words,) uint16 wire stream; states (S,) int64 in
    [0, 2^32); freqs_gc/cums_gc (G, n_ctx, 256); counts (L,) per-step
    word counts or None.  Returns syms (S, L) uint8 (a transposed view of
    the kernel's (L, S) output)."""
    _require(words.dim() == 1 and words.dtype == torch.uint16,
             f"words must be 1-D uint16, got {words.dtype}")
    _require(states.dim() == 1, "states must be (S,)")
    _require(counts is None or counts.shape == (l,),
             f"counts must be ({l},)")
    _require(states.device == words.device, "words and states on two devices")
    with profiling.span("vcf.rans.decode"):
        if words.device.type == "cpu":
            return rans_decode_ctx_ref(words, states, freqs_gc, cums_gc, l,
                                       counts)
        _require_cuda(words)
        f, c = _check_tables(freqs_gc, cums_gc)
        g, n_ctx = f.shape[:2]
        s_streams = states.shape[0]
        _require(s_streams % g == 0, f"{s_streams} lanes do not split into "
                 f"{g} groups")
        dev = words.device
        lut = class_lut_on(n_ctx, dev)
        out, err = launch_decode(words, states, cum_rows(f, c, dev), lut,
                                 counts, l, g, n_ctx)
        rans_decode_ctx.launches += 1
        raise_decode_error(err)
        return out.t()


rans_decode_ctx.launches = 0


# ---------------------------------------------------------------------------
# The routing-free grid decode, context mode
# ---------------------------------------------------------------------------

def rans_decode_ctx_grid_ref(raw: torch.Tensor, states: torch.Tensor,
                             freqs_gc, cums_gc, l: int) -> torch.Tensor:
    """Plain torch context grid decode: `rans_decode_ctx_ref`'s resolve
    and the grid's words, no routing.  Returns syms (L, S) uint8."""
    resolve = _ctx_resolver(freqs_gc, cums_gc, states.shape[0], raw.device)
    return grid_steps_ref(raw, states, l, resolve)


def rans_decode_ctx_grid(raw: torch.Tensor, states: torch.Tensor,
                         freqs_gc, cums_gc, l: int) -> torch.Tensor:
    """raw (L, S) int32 grid from the context encode ((emit << 16) |
    low16 per decode step); states (S,) int64 in [0, 2^32);
    freqs_gc/cums_gc (G, n_ctx, 256).  Returns syms (S, L) uint8 (a
    transposed view of the (L, S) output)."""
    with profiling.span("vcf.rans.decode"):
        f, c = _check_tables(freqs_gc, cums_gc)
        g, n_ctx = f.shape[:2]
        check_grid(raw, states, l, g)
        if raw.device.type == "cpu":
            return rans_decode_ctx_grid_ref(raw, states, f, c, l).t()
        _require_cuda(raw)
        dev = raw.device
        lut = class_lut_on(n_ctx, dev)
        out = launch_grid("vcf_rans_decode_ctx_grid", raw, states,
                          (cum_rows(f, c, dev), lut), l, g, n_ctx)
        rans_decode_ctx_grid.launches += 1
        return out.t()


rans_decode_ctx_grid.launches = 0
