"""Grouped rANS decode kernel K3 (port of vcf_tpu/ops/pallas/rans_decode.py).

K3 `rans_decode_grouped` replaces `pallas_decode_grouped` together with
its XLA pre-pass `build_windows`: it reads the wire words directly, so it
needs no windows.  Given the per-step counts of a v2 sidecar (every
grans/cgrans stream) it launches the look-back kernel, many blocks, each
step's pointer from the counts; without counts (the dense v0 stream) the
one-block kernel, which carries the stream pointer itself.  A stream that
does not decode cleanly (count mismatch, read past the end, words left
over) raises ValueError naming the first bad step, never returns
garbage.  It returns a transposed view of the kernel's (L, S) output, so
the caller's `.t()` is vcf_tpu's `lmajor` output at no cost.  Design
notes and bounds are in csrc/rans_decode.cu.

`rans_decode_grouped_grid` replaces `pallas_decode_grouped_grid`: the
routing-free decode straight from K1's raw (L, S) grid, whose emit flags
are the decoder's renormalization flags lane for lane.  A grid whose
flags disagree with the decode, or whose states do not end at RANS_L,
raises ValueError.  Its launch shape (lanes a block, where the tables
live, the symbol lookup's bucket size) is picked from the shape:
`decode_plan` asks the card's C entry, `decode_plan_for` is the same
rule in Python.  Design notes and bounds are in csrc/rans_grid.cu.

Each wrapper runs the plain torch version for a CPU tensor and launches
its CUDA kernel for a CUDA tensor; `launches` counts kernel launches.
Both decodes run in a `vcf.rans.decode` span (`utils.profiling`); the
read-back of a launch's error flag is `rans_encode.to_host`'s
(`vcf.rans.sync`, counted in `host_syncs`).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from vcf_tpu_torch.ops.cuda import _build
from vcf_tpu_torch.ops.cuda.rans_encode import (
    K_PROB, MASK, RANS_L, _require, _require_cuda, pack_tables, to_host,
    u32_as_i32)
from vcf_tpu_torch.utils import profiling

_ERRORS = {1: "renormalization count differs from the counts sidecar",
           2: "stream ends before the last step",
           3: "words left over after the last step"}


def rans_decode_grouped_ref(words: torch.Tensor, states: torch.Tensor,
                            freqs_g, cums_g, l: int,
                            counts: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Plain torch K3: an int64 loop over steps with a torch.cumsum
    rank.  Returns syms (S, L) uint8."""
    resolve = _resolver(freqs_g, cums_g, states.shape[0], words.device)
    return decode_steps_ref(words, states, l, counts, resolve)


def _resolver(freqs_g, cums_g, s_streams: int, dev):
    """Order 0's `resolve(slot)` for the plain decodes: every lane's
    (symbol, f, cum) by one searchsorted over its group's cums."""
    f_tab = torch.as_tensor(freqs_g).to(dev, torch.int64)
    c_tab = torch.as_tensor(cums_g).to(dev, torch.int64)
    g = f_tab.shape[0]
    sg = s_streams // g
    grp = torch.arange(s_streams, device=dev) // sg

    def resolve(slot):
        v = torch.searchsorted(c_tab, slot.view(g, sg), right=True
                               ).view(s_streams) - 1
        return v, f_tab[grp, v], c_tab[grp, v]

    return resolve


def decode_steps_ref(words: torch.Tensor, states: torch.Tensor, l: int,
                     counts: Optional[torch.Tensor], resolve) -> torch.Tensor:
    """The step loop of both K3 modes' plain versions: `resolve(slot)`
    gives every lane's (symbol, f, cum) at the current step, as int64;
    it is called once per step, in step order.  Returns syms (S, L)
    uint8; raises ValueError as the kernel does."""
    dev = words.device
    s_streams = states.shape[0]
    n_words = words.numel()
    # one zero word past the end keeps the gather in range; a stream that
    # needs it is caught by the pointer check below
    w64 = torch.cat([words.to(torch.int64),
                     torch.zeros(1, dtype=torch.int64, device=dev)])
    x = states.to(dev, torch.int64).clone()
    out = torch.empty((l, s_streams), dtype=torch.uint8, device=dev)
    totals = torch.empty(l, dtype=torch.int64, device=dev)
    ptr = torch.zeros((), dtype=torch.int64, device=dev)
    for t in range(l):
        slot = x & MASK
        v, f, cum = resolve(slot)
        x = f * (x >> K_PROB) + slot - cum
        renorm = (x < RANS_L).to(torch.int64)
        rank = torch.cumsum(renorm, 0) - renorm
        w = w64[(ptr + rank).clamp(max=n_words)]
        x = torch.where(renorm.bool(), (x << 16) | w, x)
        totals[t] = renorm.sum()
        ptr = ptr + totals[t]
        out[t] = v.to(torch.uint8)
    code, step = first_error(totals.cpu(), counts, n_words)
    if code:
        raise ValueError(f"rans decode: {_ERRORS[code]} (step {step})")
    return out.t()


def first_error(totals: torch.Tensor, counts: Optional[torch.Tensor],
                n_words: int) -> Tuple[int, int]:
    """(code, step) of the first error of a decode whose steps took
    `totals` words (0 when it decoded cleanly), as the kernels report it:
    at the first step whose total differs from counts[t] (code 1) or whose
    words end past n_words (code 2; code 1 first on the same step), else
    code 3 at step L when words are left over.  The steps after the first
    error do not matter: the kernels stop there."""
    ends = torch.cumsum(totals, 0)
    bad = ends > n_words
    mismatch = torch.zeros_like(bad)
    if counts is not None:
        mismatch = totals != counts.cpu().to(torch.int64)
    hit = (bad | mismatch).nonzero()
    if hit.numel():
        step = int(hit[0])
        return (1 if bool(mismatch[step]) else 2), step
    used = int(ends[-1]) if totals.numel() else 0
    return (3 if used != n_words else 0), totals.numel()


def rans_decode_grouped(words: torch.Tensor, states: torch.Tensor,
                        freqs_g, cums_g, l: int,
                        counts: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """words (n_words,) uint16 wire stream; states (S,) int64 in
    [0, 2^32); freqs_g/cums_g (G, 256); counts (L,) per-step word counts
    or None.  Returns syms (S, L) uint8, a transposed view of the kernel's
    (L, S) output."""
    _require(words.dim() == 1 and words.dtype == torch.uint16,
             f"words must be 1-D uint16, got {words.dtype}")
    _require(states.dim() == 1, "states must be (S,)")
    g = torch.as_tensor(freqs_g).shape[0]
    s_streams = states.shape[0]
    _require(g >= 1 and s_streams % g == 0,
             f"{s_streams} lanes do not split into {g} groups")
    _require(counts is None or counts.shape == (l,),
             f"counts must be ({l},)")
    _require(states.device == words.device, "words and states on two devices")
    with profiling.span("vcf.rans.decode"):
        if words.device.type == "cpu":
            return rans_decode_grouped_ref(words, states, freqs_g, cums_g,
                                           l, counts)
        _require_cuda(words)
        out, err = launch_decode(words, states,
                                 pack_tables(freqs_g, cums_g, words.device),
                                 None, counts, l, g, 0)
        rans_decode_grouped.launches += 1
        raise_decode_error(err)
        return out.t()


def launch_decode(words: torch.Tensor, states: torch.Tensor,
                  tab: torch.Tensor, lut: Optional[torch.Tensor],
                  counts: Optional[torch.Tensor], l: int, g: int, n_ctx: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K3 in either mode on the card (n_ctx = 0 and lut None: order
    0 with (G, 256) packed tables; else the context mode with its cumulative
    rows and class LUT): the look-back kernel when counts are given, the
    one-block kernel when not.  Returns (out (L, S)
    u8, err (2,) int32 code and step)."""
    dev = words.device
    lib = _build.load()
    words = words.contiguous()
    st32 = u32_as_i32(states.to(torch.int64)).contiguous()
    s_streams = st32.numel()
    out = torch.empty((l, s_streams), dtype=torch.uint8, device=dev)
    err = torch.zeros(2, dtype=torch.int32, device=dev)
    lut_p = lut.data_ptr() if lut is not None else None
    stream = _build.stream_of(words)
    with torch.cuda.device(dev):
        if counts is not None:
            # (L, blocks) u64 descriptors, the ticket and the abort flag:
            # the launch zeroes them with one memset
            lanes = lib.vcf_rans_decode_lookback_lanes()
            blocks = max(1, -(-s_streams // lanes))
            scratch = torch.empty(2 * l * blocks + 2, dtype=torch.int32,
                                  device=dev)
            cnt = counts.to(dev, torch.int32).contiguous()
            rc = lib.vcf_rans_decode_lookback(
                words.data_ptr(), words.numel(), st32.data_ptr(),
                tab.data_ptr(), lut_p, cnt.data_ptr(), out.data_ptr(),
                err.data_ptr(), scratch.data_ptr(), s_streams, l, g, n_ctx,
                stream)
        else:
            # the one-block kernel keeps each thread's lanes' states (and
            # previous symbols) in a scratch of whole rounds of threads
            threads = lib.vcf_rans_decode_threads()
            n_scratch = -(-s_streams // threads) * threads
            xs = torch.empty(n_scratch, dtype=torch.int32, device=dev)
            if lut is None:
                rc = lib.vcf_rans_decode_grouped(
                    words.data_ptr(), words.numel(), st32.data_ptr(),
                    xs.data_ptr(), tab.data_ptr(), out.data_ptr(),
                    err.data_ptr(), s_streams, l, g, stream)
            else:
                prev = torch.empty(n_scratch, dtype=torch.uint8, device=dev)
                rc = lib.vcf_rans_decode_ctx(
                    words.data_ptr(), words.numel(), st32.data_ptr(),
                    xs.data_ptr(), prev.data_ptr(), tab.data_ptr(), lut_p,
                    out.data_ptr(), err.data_ptr(), s_streams, l, g, n_ctx,
                    stream)
    _build.check(rc, "rans_decode")
    return out, err


def raise_decode_error(err: torch.Tensor) -> None:
    """Raise the ValueError of a K3 launch's (code, step), if any."""
    code, step = to_host(err).tolist()
    if code:
        raise ValueError(f"rans decode: {_ERRORS[code]} (step {step})")


rans_decode_grouped.launches = 0


# ---------------------------------------------------------------------------
# The routing-free grid decode
# ---------------------------------------------------------------------------

_GRID_ERROR = ("rans grid decode: the raw grid's emit flags differ from the "
               "decode's renormalizations, or a state does not end at RANS_L")


def grid_steps_ref(raw: torch.Tensor, states: torch.Tensor, l: int,
                   resolve) -> torch.Tensor:
    """The step loop of both grid decodes' plain versions: `resolve(slot)`
    gives every lane's (symbol, f, cum) at the current step (called once
    per step, in step order); lane s renormalizes with raw[t, s] & 0xFFFF.
    Returns syms (L, S) uint8; raises ValueError as the kernel does."""
    dev = raw.device
    x = states.to(dev, torch.int64).clone()
    out = torch.empty((l, x.numel()), dtype=torch.uint8, device=dev)
    bad = torch.zeros((), dtype=torch.bool, device=dev)
    for t in range(l):
        slot = x & MASK
        v, f, cum = resolve(slot)
        x = f * (x >> K_PROB) + slot - cum
        word = raw[t].to(torch.int64)
        renorm = x < RANS_L
        bad |= (renorm != ((word >> 16) != 0)).any()
        x = torch.where(renorm, (x << 16) | (word & 0xFFFF), x)
        out[t] = v.to(torch.uint8)
    if bool(bad | (x != RANS_L).any()):
        raise ValueError(_GRID_ERROR)
    return out


def check_grid(raw: torch.Tensor, states: torch.Tensor, l: int, g: int
               ) -> None:
    """Raise unless raw is the (l, S) int32 grid of S = states.numel()
    lanes on the device of states, and the lanes split into g groups."""
    _require(raw.dim() == 2 and raw.dtype == torch.int32,
             f"raw grid must be (L, S) int32, got {raw.dtype} "
             f"{tuple(raw.shape)}")
    _require(states.dim() == 1 and raw.shape == (l, states.shape[0]),
             f"raw grid {tuple(raw.shape)} is not ({l}, S) for "
             f"{states.shape[0]} states")
    _require(g >= 1 and states.shape[0] % g == 0,
             f"{states.shape[0]} lanes do not split into {g} groups")
    _require(states.device == raw.device, "raw and states on two devices")


#: the grid decode's launch constants (csrc/rans_grid.cu): most lanes a
#: block, steps a staged tile, tiles staged at once, the shifts a bucket
#: of the symbol lookup may take (2^shift slots) and the bytes of a
#: block's tables that pick the least of them
GRID_LANES, GRID_TILE, GRID_STAGES = 128, 32, 2
GRID_SHIFTS = range(3, 9)
GRID_TABLE_BUDGET = 24 * 1024


def decode_plan_for(s_streams: int, g: int, n_ctx: int, sms: int) -> dict:
    """The grid decode's launch shape for S lanes in G groups (n_ctx 0:
    order 0) on a card of `sms` SMs, as csrc/rans_grid.cu's `grid_plan`
    computes it: lanes a block (the most of 128, 64, 32 that still gives
    every SM a block); where the blocks keep their groups' tables
    ("shared", with a bucket table of 2^shift slots a bucket, the least
    shift from 3 to 8 whose tables fit GRID_TABLE_BUDGET; else "global",
    shift 8 unused); steps a tile; dynamic shared memory bytes (the tile
    stages, the tables)."""
    _require(s_streams >= 1 and g >= 1 and s_streams % g == 0
             and n_ctx >= 0, f"no grid plan for S={s_streams} G={g} "
             f"n_ctx={n_ctx}")
    lanes = GRID_LANES
    while lanes > 32 and -(-s_streams // lanes) < sms:
        lanes //= 2
    sg = s_streams // g
    # a block starts at a multiple of `lanes`: at most gcd(lanes, sg)
    # lanes before a group's end
    span = min(g, (sg - math.gcd(lanes, sg) + lanes - 1) // sg + 1)
    rows = span * max(n_ctx, 1)
    table = 2 * 257 if n_ctx else 4 * 256
    fits = [sh for sh in GRID_SHIFTS
            if rows * (table + (1 << (K_PROB - sh)) + 4) <= GRID_TABLE_BUDGET]
    shift = fits[0] if fits else GRID_SHIFTS[-1]
    tables = rows * (table + (1 << (K_PROB - shift)) + 4) if fits else 0
    return {"lanes": lanes, "tables": "shared" if fits else "global",
            "shift": shift, "tile": GRID_TILE,
            "smem": GRID_STAGES * GRID_TILE * lanes * 4 + tables}


def decode_plan(s_streams: int, g: int, n_ctx: int = 0) -> dict:
    """`decode_plan_for` as the card's C entry computes it (on the current
    card)."""
    out = (ctypes.c_int * 5)()
    _build.check(_build.load().vcf_rans_decode_grid_plan(
        s_streams, g, n_ctx, out), "rans_decode_grid_plan")
    return {"lanes": out[0], "tables": "shared" if out[1] else "global",
            "shift": out[2], "tile": out[3], "smem": out[4]}


def launch_grid(entry: str, raw: torch.Tensor, states: torch.Tensor,
                tables: tuple, l: int, g: int, *extra) -> torch.Tensor:
    """Launch one C entry of csrc/rans_grid.cu; returns its (L, S) u8
    output, raising ValueError if it flagged the grid."""
    dev = raw.device
    lib = _build.load()
    raw = raw.contiguous()
    st32 = u32_as_i32(states.to(torch.int64)).contiguous()
    s_streams = st32.numel()
    out = torch.empty((l, s_streams), dtype=torch.uint8, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(
            raw.data_ptr(), st32.data_ptr(), *[t.data_ptr() for t in tables],
            out.data_ptr(), err.data_ptr(), s_streams, l, g, *extra,
            _build.stream_of(raw))
    _build.check(rc, entry)
    if int(to_host(err)[0]):
        raise ValueError(_GRID_ERROR)
    return out


def rans_decode_grouped_grid_ref(raw: torch.Tensor, states: torch.Tensor,
                                 freqs_g, cums_g, l: int) -> torch.Tensor:
    """Plain torch grid decode: K3's resolve, no routing.  Returns syms
    (L, S) uint8."""
    resolve = _resolver(freqs_g, cums_g, states.shape[0], raw.device)
    return grid_steps_ref(raw, states, l, resolve)


def rans_decode_grouped_grid(raw: torch.Tensor, states: torch.Tensor,
                             freqs_g, cums_g, l: int) -> torch.Tensor:
    """raw (L, S) int32 grid from K1 ((emit << 16) | low16 per decode
    step); states (S,) int64 in [0, 2^32); freqs_g/cums_g (G, 256).
    Returns syms (S, L) uint8, a transposed view of the (L, S) output
    (its `.t()` is vcf_tpu's `lmajor` output, at no cost)."""
    g = torch.as_tensor(freqs_g).shape[0]
    check_grid(raw, states, l, g)
    with profiling.span("vcf.rans.decode"):
        if raw.device.type == "cpu":
            out = rans_decode_grouped_grid_ref(raw, states, freqs_g, cums_g,
                                               l)
        else:
            _require_cuda(raw)
            tab = pack_tables(freqs_g, cums_g, raw.device)
            out = launch_grid("vcf_rans_decode_grid", raw, states, (tab,), l,
                              g)
            rans_decode_grouped_grid.launches += 1
    return out.t()


rans_decode_grouped_grid.launches = 0
