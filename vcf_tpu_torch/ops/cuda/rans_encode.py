"""Grouped rANS encode kernels K1 and K2 (port of
vcf_tpu/ops/pallas/rans_encode.py).

K1 `rans_encode_grouped` replaces `pallas_encode_grouped_raw`: syms (S, L)
u8 with lane s using table s // (S // G) -> the raw grid (L, S) int32 of
(emit << 16) | low16 in decode-step order, and the final states.  The
kernel reads (L, S): given the transposed view `lanes.t()` of (L, S)
lanes it is `pallas_encode_grouped_raw_u8` (either layout); a contiguous
(L, S) tensor reaches it with no copy, any other layout through one
`contiguous()` copy (the lanes of `entropy.rans.grid_lanes_lmajor` are
a strided view, so they take that copy).
K2 `rans_compact` replaces `finish_stream_pallas`: the raw grid -> the
wire words in (t asc, s asc) order, their count and the per-step counts.
K2's row mode `rans_compact_rows` packs each row of the raw grid on its
own: `rans_encode_rows` (K1 then the row mode) replaces the compacting
encodes `pallas_encode_grouped` and `pallas_encode_grouped_u8`, and
`assemble_stream` (torch ops, as it was XLA in vcf_tpu) joins the rows
into the wire words.  Design notes and bounds are in csrc/rans_encode.cu.

Each wrapper runs the plain torch version for a CPU tensor and launches
its CUDA kernel for a CUDA tensor; nothing else.  `launches` counts the
kernel launches.  uint32 state arithmetic runs in int64 with masks in
the plain versions (torch's uint32 support is partial) and natively in
the kernels.

Spans (`utils.profiling`): `vcf.rans.encode` (K1), `vcf.rans.compact`
(K2 and its row mode), `vcf.rans.assemble`, `vcf.rans.tables` (`pack_tables`),
`vcf.rans.layout` around K1's (L, S) copy (its bytes counted in
`layout_bytes`), and `vcf.rans.sync` around each read-back of a CUDA
tensor (`to_host`, counted in `host_syncs`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vcf_tpu_torch.ops.cuda import _build
from vcf_tpu_torch.utils import profiling

#: steps of K1's staged symbol tiles (ENC_TILE in csrc/rans_encode.cu);
#: the tests' ragged step counts sit around it
ENCODE_TILE = 64
K_PROB = 15
RANS_L = 1 << 16
MASK = (1 << K_PROB) - 1
_SHIFT_EMIT = 32 - K_PROB  # x >= f * 2^_SHIFT_EMIT <=> (x >> _SHIFT_EMIT) >= f


def pack_tables(freqs_g: torch.Tensor, cums_g: torch.Tensor,
                device: torch.device) -> torch.Tensor:
    """(G, 256) freqs and cums -> (G, 256) int32 entries f | (cum << 16),
    the kernels' table layout (f <= 2^15 and cum < 2^15 fit 16 bits)."""
    with profiling.span("vcf.rans.tables"):
        f = torch.as_tensor(freqs_g).to(torch.int64)
        c = torch.as_tensor(cums_g).to(torch.int64)
        if f.shape != c.shape or f.dim() != 2 or f.shape[1] != 256:
            raise ValueError(f"tables must be (G, 256), got "
                             f"{tuple(f.shape)} and {tuple(c.shape)}")
        return (f | (c << 16)).to(torch.int32).to(device).contiguous()


def to_host(t: torch.Tensor) -> torch.Tensor:
    """t on the host.  For a CUDA tensor the host waits for the card: the
    copy runs in a `vcf.rans.sync` span and counts in `host_syncs`."""
    if t.device.type != "cuda":
        return t.cpu()
    with profiling.span("vcf.rans.sync"):
        profiling.count("host_syncs")
        return t.cpu()


def u32_as_i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the same bits as int32."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def i32_as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bits of a uint32 -> its value in int64."""
    return x.to(torch.int64) & 0xFFFFFFFF


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _require_cuda(t: torch.Tensor) -> None:
    """Kernels launch on CUDA tensors only; a wrapper sends CPU tensors
    to its plain version before this check and raises for any other."""
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")


# ---------------------------------------------------------------------------
# K1: grouped encode to the raw grid
# ---------------------------------------------------------------------------

def rans_encode_grouped_ref(syms: torch.Tensor, freqs_g: torch.Tensor,
                            cums_g: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch K1: an int64 loop over steps, vectorized over lanes.
    Same state law as np_encode_grouped; returns (raw (L, S) int32,
    states (S,) int64)."""
    sym_l = syms.t().to(torch.int64)   # (L, S)
    s_streams = sym_l.shape[1]
    dev = syms.device
    g = freqs_g.shape[0]
    grp = torch.arange(s_streams, device=dev) // (s_streams // g)
    f_tab = torch.as_tensor(freqs_g).to(dev, torch.int64)
    c_tab = torch.as_tensor(cums_g).to(dev, torch.int64)
    return encode_steps_ref(f_tab[grp[None, :], sym_l],
                            c_tab[grp[None, :], sym_l])


def encode_steps_ref(f_all: torch.Tensor, c_all: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The state recursion of both K1 modes' plain versions: (L, S) int64
    (f, cum) of every symbol -> (raw (L, S) int32, states (S,) int64)."""
    l, s_streams = f_all.shape
    dev = f_all.device
    x = torch.full((s_streams,), RANS_L, dtype=torch.int64, device=dev)
    raw = torch.empty((l, s_streams), dtype=torch.int32, device=dev)
    for t in range(l - 1, -1, -1):
        f = f_all[t]
        emit = (x >> _SHIFT_EMIT) >= f
        low = x & 0xFFFF
        x = torch.where(emit, x >> 16, x)
        x = ((x // f) << K_PROB) + x % f + c_all[t]
        raw[t] = (low | (emit.to(torch.int64) << 16)).to(torch.int32)
    return raw, x


def encode_plan(s_streams: int, g: int, n_ctx: int = 0) -> Tuple[int, str]:
    """K1's launch shape on the current card for S lanes in G groups
    (n_ctx 0: order 0): (lanes a block, "shared" or "global": where its
    blocks read their groups' tables)."""
    code = _build.load().vcf_rans_encode_plan(s_streams, g, n_ctx)
    _build.check(-min(code, 0), "rans_encode_plan")
    return code // 2, "shared" if code % 2 else "global"


def launch_encode(sym_l: torch.Tensor, tab: torch.Tensor,
                  lut: Optional[torch.Tensor], g: int, n_ctx: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 in either mode on the card: sym_l (L, S) uint8
    contiguous, tab the packed tables ((G, 256) for order 0 with lut None
    and n_ctx 0; (G * n_ctx, 256) with the (256,) class LUT for the
    context mode).  Returns (raw (L, S) int32, states (S,) int32 holding
    the uint32 bits).  The wrappers check the tables and count the
    launch."""
    _require(sym_l.dim() == 2 and sym_l.dtype == torch.uint8
             and sym_l.is_contiguous(),
             "launch_encode takes contiguous (L, S) uint8 symbols")
    dev = sym_l.device
    lib = _build.load()
    l, s_streams = sym_l.shape
    raw = torch.empty((l, s_streams), dtype=torch.int32, device=dev)
    states = torch.empty(s_streams, dtype=torch.int32, device=dev)
    stream = _build.stream_of(sym_l)
    with torch.cuda.device(dev):
        if lut is None:
            rc = lib.vcf_rans_encode_grouped(
                sym_l.data_ptr(), tab.data_ptr(), raw.data_ptr(),
                states.data_ptr(), s_streams, l, g, stream)
        else:
            rc = lib.vcf_rans_encode_ctx(
                sym_l.data_ptr(), tab.data_ptr(), lut.data_ptr(),
                raw.data_ptr(), states.data_ptr(), s_streams, l, g, n_ctx,
                stream)
    _build.check(rc, "rans_encode")
    return raw, states


def rans_encode_grouped(syms: torch.Tensor, freqs_g, cums_g
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """syms (S, L) uint8 (the transposed view of contiguous (L, S) lanes
    is read with no copy), lane s on table s // (S // G); freqs_g/cums_g
    (G, 256).  Returns (raw (L, S) int32 with (emit << 16) | low16 per
    decode step, final states (S,) int64 in [0, 2^32))."""
    _require(syms.dim() == 2 and syms.dtype == torch.uint8,
             f"syms must be (S, L) uint8, got {syms.dtype} "
             f"{tuple(syms.shape)}")
    g = torch.as_tensor(freqs_g).shape[0]
    s_streams = syms.shape[0]
    _require(g >= 1 and s_streams % g == 0,
             f"{s_streams} lanes do not split into {g} groups")
    with profiling.span("vcf.rans.encode"):
        if syms.device.type == "cpu":
            return rans_encode_grouped_ref(syms, freqs_g, cums_g)
        _require_cuda(syms)
        tab = pack_tables(freqs_g, cums_g, syms.device)
        raw, states = launch_encode(_steps_major(syms), tab, None, g, 0)
        rans_encode_grouped.launches += 1
        return raw, i32_as_u32(states)


def _steps_major(syms: torch.Tensor) -> torch.Tensor:
    """(S, L) symbols as the contiguous (L, S) K1 reads (the kernel stages
    tiles of steps x lanes): no copy for the transposed view of (L, S)
    lanes, else one, in a `vcf.rans.layout` span with its bytes counted."""
    sym_l = syms.t()
    if sym_l.is_contiguous():
        return sym_l
    with profiling.span("vcf.rans.layout"):
        sym_l = sym_l.contiguous()
    profiling.count("layout_bytes", 2 * sym_l.nbytes)
    return sym_l


rans_encode_grouped.launches = 0


# ---------------------------------------------------------------------------
# K2: raw grid -> wire words
# ---------------------------------------------------------------------------

def rans_compact_ref(raw: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch K2: masked_select of the flagged low16 words."""
    flat = raw.reshape(-1)
    flags = (flat >> 16) != 0
    sel = torch.masked_select(flat & 0xFFFF, flags)
    words = torch.zeros(flat.numel(), dtype=torch.uint16, device=raw.device)
    words[:sel.numel()] = sel.to(torch.uint16)
    n_words = torch.tensor(sel.numel(), dtype=torch.int32, device=raw.device)
    counts = (raw >> 16).sum(dim=1, dtype=torch.int32)
    return words, n_words, counts


def rans_compact(raw: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """raw (L, S) int32 grid from K1 -> (words (L*S,) uint16 whose first
    n_words entries are the stream in decoder order, n_words 0-d int32,
    counts (L,) int32 words per decode step)."""
    _require(raw.dim() == 2 and raw.dtype == torch.int32,
             f"raw grid must be (L, S) int32, got {raw.dtype} "
             f"{tuple(raw.shape)}")
    with profiling.span("vcf.rans.compact"):
        if raw.device.type == "cpu":
            return rans_compact_ref(raw)
        _require_cuda(raw)
        raw = raw.contiguous()
        l, s_streams = raw.shape
        n = raw.numel()
        _require(0 < n < 1 << 31, f"grid of {n} entries out of range")
        lib = _build.load()
        n_tiles = -(-n // lib.vcf_rans_compact_tile())
        dev = raw.device
        words = torch.empty(n, dtype=torch.uint16, device=dev)
        n_words = torch.empty(1, dtype=torch.int32, device=dev)
        # the tiles' u64 descriptors, the ticket, then the counts: the
        # launch zeroes all of it with one memset
        scratch = torch.empty(2 * n_tiles + 1 + l, dtype=torch.int32,
                              device=dev)
        with torch.cuda.device(dev):
            rc = lib.vcf_rans_compact(
                raw.data_ptr(), n, s_streams, l, words.data_ptr(),
                n_words.data_ptr(), scratch.data_ptr(),
                _build.stream_of(raw))
        _build.check(rc, "rans_compact")
        rans_compact.launches += 1
        return words, n_words[0], scratch[2 * n_tiles + 1:]


rans_compact.launches = 0


# ---------------------------------------------------------------------------
# K2's row mode: each decode step's words as a prefix of its own row
# ---------------------------------------------------------------------------

def _as_i16(v: torch.Tensor) -> torch.Tensor:
    """16-bit values held in a wider int -> the same bits as int16."""
    return torch.where(v >= 1 << 15, v - (1 << 16), v).to(torch.int16)


def rans_compact_rows_ref(raw: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch row mode: a stable per-row rank of the flagged words
    (cumsum along the row), one scatter."""
    l, s_streams = raw.shape
    flags = (raw >> 16) != 0
    rank = torch.cumsum(flags, dim=1) - 1
    dest = (torch.arange(l, device=raw.device)[:, None] * s_streams + rank)
    rows = torch.zeros(l * s_streams, dtype=torch.int16, device=raw.device)
    rows[dest[flags]] = _as_i16((raw & 0xFFFF)[flags])
    return rows.view(l, s_streams), flags.sum(dim=1, dtype=torch.int32)


def rans_compact_rows(raw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """raw (L, S) int32 grid from K1 -> (rows (L, S) int16: row t holds
    the low16 words of the lanes that emit at decode step t, in lane
    order, as a prefix, the rest of the row unspecified (as in vcf_tpu's
    kernels; the plain version zeroes it); counts (L,) int32 prefix
    lengths)."""
    _require(raw.dim() == 2 and raw.dtype == torch.int32,
             f"raw grid must be (L, S) int32, got {raw.dtype} "
             f"{tuple(raw.shape)}")
    with profiling.span("vcf.rans.compact"):
        if raw.device.type == "cpu":
            return rans_compact_rows_ref(raw)
        _require_cuda(raw)
        raw = raw.contiguous()
        l, s_streams = raw.shape
        _require(l > 0 and s_streams > 0, "empty raw grid")
        lib = _build.load()
        rows = torch.empty((l, s_streams), dtype=torch.int16,
                           device=raw.device)
        counts = torch.empty(l, dtype=torch.int32, device=raw.device)
        with torch.cuda.device(raw.device):
            rc = lib.vcf_rans_compact_rows(raw.data_ptr(), s_streams, l,
                                           rows.data_ptr(), counts.data_ptr(),
                                           _build.stream_of(raw))
        _build.check(rc, "rans_compact_rows")
        rans_compact_rows.launches += 1
        return rows, counts


rans_compact_rows.launches = 0


def rans_encode_rows(syms: torch.Tensor, freqs_g, cums_g
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 then K2's row mode: syms (S, L) uint8 -> (rows (L, S) int16
    per-step word prefixes, counts (L,) int32, states (S,) int64), the
    output of vcf_tpu's `pallas_encode_grouped` and
    `pallas_encode_grouped_u8`; only each row's prefix is defined."""
    raw, states = rans_encode_grouped(syms, freqs_g, cums_g)
    rows, counts = rans_compact_rows(raw)
    return rows, counts, states


def assemble_stream(rows: torch.Tensor, counts: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, S) int16 prefix rows + (L,) counts -> (words (L*S,) uint16 with
    the stream as a prefix and zeros after it, n_words 0-d int32),
    vcf_tpu's `assemble_stream` (XLA there, torch ops here): row t's
    prefix lands at the sum of the counts before it, one gather.  `rows`
    may be a column slice rows[:, :cap] (then L * cap words) if no count
    passes cap."""
    _require(rows.dim() == 2 and rows.dtype == torch.int16,
             f"rows must be (L, S) int16, got {rows.dtype} "
             f"{tuple(rows.shape)}")
    l, cap = rows.shape
    _require(counts.shape == (l,), f"counts must be ({l},)")
    with profiling.span("vcf.rans.assemble"):
        c = counts.to(torch.int64)
        ends = torch.cumsum(c, 0)
        n_words, c_max = (int(v) for v in
                          to_host(torch.stack([ends[-1], c.max()])))
        _require(c_max <= cap, f"a step has {c_max} words, more than the "
                 f"{cap} columns of the rows")
        pos = torch.arange(n_words, device=rows.device)
        t = torch.searchsorted(ends, pos, right=True)
        words = torch.zeros(l * cap, dtype=torch.int16, device=rows.device)
        words[:n_words] = rows[t, pos - (ends[t] - c[t])]
        return (words.view(torch.uint16),
                torch.tensor(n_words, dtype=torch.int32, device=rows.device))
