"""A/B of the routing-free grid decode (csrc/rans_grid.cu, both modes)
through each tree's own wrappers, on one GPU: the current tree against
another commit's tree and against source variants.

    git archive <commit> | tar -x -C _ab/parent
    python3 grid_ab.py [--parent _ab/parent] [--variants shift4 tile16 ...] \
        [--kernels-only] [--rounds N] [--ptxas] [--out grid_ab.json]

With --parent (another commit's tree, unpacked under the git-ignored
_ab/), each tree runs in a process of its own that imports that tree's
vcf_tpu_torch, builds its kernels and times, by CUDA events after a
warm-up:

- the grid decodes on chip_smoke.py's grids: phase 3e's order-0 grid
  (the lane-grid lanes of the 8 frames, S = 65536, L = 765, G = 64) and
  3d's context grids (4 and 15 classes), and 4e's DWT context grid (S =
  8704, L = 3060, G = 17, 4 classes); each as the wrapper is called
  (`ms`, 20 calls) and as its C entry launched alone (`launch_ms`: the
  states' int32 copy, tables, output and err made before, no readback;
  20 calls); for the context grids also the wrapper's table check
  (`_check_tables`) and class LUT by the host clock (median of 20);
- unless --kernels-only, phase 4f's device-resident lane-grid decode and
  phase 4g's planar IPP decode (5 calls each).

It prints one JSON line: the times and a SHA-256 of every output.  The
runs go in turns, (parent, current, current, parent), `--rounds` times,
and every output of every run must hash alike (bit for bit).  One JSON
line a row follows, the card's name and power limit first: each tree's
times (both turns of each round) and, for the kernels, the bound
(chip_smoke.py's `bound`) and the multiples of it.

--variants builds each named edit of the current rans_grid.cu (a+b: the
edits of both) into a library of its own under _ab/ and launches it
alone beside the current build on the same grids and tables, in one
process, in turns (variant, current, current, variant; 20 launches
each); an exact variant's output must equal the current build's.
Exact variants (the design's choices): fixed6 (64 slots a bucket at every shape, tables up to 48 KiB: the first
form of this design), min4 (at least 16 slots a bucket), budget48
(tables up to 48 KiB pick the shift, so fewer blocks share an SM), lut
(one bucket a slot, a full slot -> symbol table, where a block's tables
fit 160 KiB), search (every step searches all 256 symbols: the first
design's 8 probes, on the staged tiles), uniform (the search a warp's
lanes in step: a vote a step and selects, no divergent loop), tile16 /
tile64 (16 / 64 steps a tile), stages3 (three tiles staged at once),
unroll1 / unroll4 (steps whose words are read ahead), guard8 (the
search as 8 unrolled probes behind one forward branch), expect (the
loop marked unlikely).  Timing only
(wrong outputs; what one part of a step costs): nostore (no symbol
stored), nosearch (the bucket's first symbol taken, no search),
branchonly (one forward step to the next bucket's symbol in place of
the loop), select1 (the same as a select).  `--ptxas` first compiles the
current rans_grid.cu with `-Xptxas -v` and prints the registers, spills
and shared memory of each kernel instance.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

import ab_common as ab

REPS = 20
# name -> (exact: its outputs must equal the current build's, edits of
# csrc/rans_grid.cu)
VARIANTS = {
    "fixed6": (True, [("constexpr int GRID_SHIFT_MIN = 3;",
                       "constexpr int GRID_SHIFT_MIN = 6;"),
                      ("constexpr size_t GRID_TABLE_BUDGET = 24 * 1024;",
                       "constexpr size_t GRID_TABLE_BUDGET = 48 * 1024;")]),
    "min4": (True, [("constexpr int GRID_SHIFT_MIN = 3;",
                     "constexpr int GRID_SHIFT_MIN = 4;")]),
    "budget48": (True, [("constexpr size_t GRID_TABLE_BUDGET = 24 * 1024;",
                         "constexpr size_t GRID_TABLE_BUDGET = 48 * 1024;")]),
    "lut": (True, [("constexpr int GRID_SHIFT_MIN = 3;",
                    "constexpr int GRID_SHIFT_MIN = 0;"),
                   ("constexpr size_t GRID_TABLE_BUDGET = 24 * 1024;",
                    "constexpr size_t GRID_TABLE_BUDGET = 160 * 1024;")]),
    "search": (True, [("  if constexpr (SMEM) {\n    const int b",
                       "  if constexpr (false) {\n    const int b")]),
    "uniform": (True, [("""  while (v < hi) {
    const int mid = (v + hi + 1) >> 1;
    if (cum_at<CTX>(row, mid) <= slot)
      v = mid;
    else
      hi = mid - 1;
  }""", """  while (__any_sync(__activemask(), v < hi)) {
    const bool go = v < hi;
    const int mid = go ? (v + hi + 1) >> 1 : v;
    const bool le = cum_at<CTX>(row, mid) <= slot;
    v = go && le ? mid : v;
    hi = go && !le ? mid - 1 : hi;
  }""")]),
    "tile16": (True, [("constexpr int GRID_TILE = 32;",
                       "constexpr int GRID_TILE = 16;")]),
    "tile64": (True, [("constexpr int GRID_TILE = 32;",
                       "constexpr int GRID_TILE = 64;")]),
    "stages3": (True, [("constexpr int GRID_STAGES = 2;",
                        "constexpr int GRID_STAGES = 3;")]),
    "unroll1": (True, [("constexpr int GRID_UNROLL = 8;",
                        "constexpr int GRID_UNROLL = 1;")]),
    "unroll4": (True, [("constexpr int GRID_UNROLL = 8;",
                        "constexpr int GRID_UNROLL = 4;")]),
    # timing only (wrong outputs): what one part of a step costs
    "nostore": (False, [("        *o_t = (uint8_t)v;",
                         "        if (v == 300) *o_t = 0;")]),
    "nosearch": (False, [("  while (v < hi) {", "  while (v < hi && hi < 0) {")]),
    "guard8": (True, [("""  while (v < hi) {
    const int mid = (v + hi + 1) >> 1;
    if (cum_at<CTX>(row, mid) <= slot)
      v = mid;
    else
      hi = mid - 1;
  }""", """  if (v < hi) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int mid = (v + hi + 1) >> 1;
      const bool le = cum_at<CTX>(row, mid) <= slot;
      v = le ? mid : v;
      hi = le ? hi : mid - 1;
    }
  }""")]),
    "expect": (True, [("  while (v < hi) {",
                       "  while (__builtin_expect(v < hi, 0)) {")]),
    "branchonly": (False, [("""  while (v < hi) {
    const int mid = (v + hi + 1) >> 1;
    if (cum_at<CTX>(row, mid) <= slot)
      v = mid;
    else
      hi = mid - 1;
  }""", """  if (v < hi && cum_at<CTX>(row, hi) <= slot) v = hi;""")]),
    "select1": (False, [("""  while (v < hi) {
    const int mid = (v + hi + 1) >> 1;
    if (cum_at<CTX>(row, mid) <= slot)
      v = mid;
    else
      hi = mid - 1;
  }""", """  const uint32_t c1 = cum_at<CTX>(row, min(v + 1, 255));
  v = v < hi && c1 <= slot ? v + 1 : v;""")]),
}


def kernel_inputs(cs, dev) -> dict:
    """The grids of phases 3e, 3d and 4e: name -> (entry, raw, states,
    freqs, cums, l, n_ctx)."""
    import numpy as np
    import torch

    from vcf_tpu_torch import Codec, CodecConfig
    from vcf_tpu_torch.entropy import dwt_device as dd
    from vcf_tpu_torch.entropy import rans
    from vcf_tpu_torch.ops import color as color_ops
    from vcf_tpu_torch.ops.cuda import dct_kernel as dk
    from vcf_tpu_torch.ops.cuda import rans_ctx as rc
    from vcf_tpu_torch.ops.cuda import rans_encode as re_

    base, frames = cs.clip_frames()
    px = torch.from_numpy(frames).to(dev).permute(0, 3, 1, 2).contiguous()
    lanes, _, _ = cs.grid_lanes_of(dk.fused_cdct_quantize(
        px, dk.static_mat(color_ops.YCOCG_FWD), grid_layout=True))
    fg, cg, _ = cs.grid_tables(dev, lanes)
    raw, st = re_.rans_encode_grouped(lanes.t(), fg, cg)
    out = {"3e order 0": ("vcf_rans_decode_grid", raw, st, fg, cg,
                          lanes.shape[0], 0)}
    planes = cs.index_planes(Codec(CodecConfig(entropy="grans"), device=dev),
                             frames)
    s_streams = rans.RANSCodec._pick_streams(planes.numel(), 65536)
    lanes_c = rans.subband_lanes_ctx(planes, 8, s_streams)
    for n_ctx in (4, 15):
        fgc, cgc = rans.ctx_freqs_from_counts(
            rans.ctx_group_histograms(lanes_c, 64, n_ctx).cpu().numpy())
        fgc, cgc = (torch.from_numpy(t.astype(np.int64)).to(dev)
                    for t in (fgc, cgc))
        raw_c, st_c = rc.rans_encode_ctx(lanes_c, fgc, cgc)
        out[f"3d {n_ctx} classes"] = ("vcf_rans_decode_ctx_grid", raw_c, st_c,
                                      fgc, cgc, lanes_c.shape[1], n_ctx)
    codec = Codec(CodecConfig(spatial="dwt", qss=cs.DWT_QSS, entropy="cgrans"),
                  device=dev)
    stream = codec.encode(base)
    g, sg, l, *_, fgd, cgd, n_ctx = dd.unpack_model(stream["gdwt_model"])
    grid = dd.bands_to_grid(codec._dwt._grid_bands(codec, base), sg, l)
    fgd, cgd = (torch.from_numpy(t.astype(np.int64)).to(dev)
                for t in (fgd, cgd))
    raw_d, st_d = rc.rans_encode_ctx(grid, fgd, cgd)
    out["4e DWT 4 classes"] = ("vcf_rans_decode_ctx_grid", raw_d, st_d, fgd,
                               cgd, l, n_ctx)
    return out


def time_tree(root: str, kernels_only: bool) -> dict:
    """Time and hash this process's tree (see the module's docstring)."""
    cs = ab.import_tree(root)
    import torch

    from vcf_tpu_torch.io import test_video
    from vcf_tpu_torch.ops import color as color_ops
    from vcf_tpu_torch.ops.cuda import dct_kernel as dk
    from vcf_tpu_torch.ops.cuda import rans_ctx as rc
    from vcf_tpu_torch.ops.cuda import rans_decode as rd
    from vcf_tpu_torch.ops.cuda import rans_encode as re_

    with ab.quiet():
        dev = cs.phase_device()
        inputs = kernel_inputs(cs, dev)
    out = {"tree": os.path.relpath(root, ab.ROOT), "rows": {}, "paths": {}}
    for key, (entry, raw, st, fg, cg, l, n_ctx) in inputs.items():
        g = fg.shape[0]
        if n_ctx:
            def call(raw=raw, st=st, fg=fg, cg=cg, l=l):
                return rc.rans_decode_ctx_grid(raw, st, fg, cg, l)
            tables = (rc.cum_rows(fg, cg, dev),
                      torch.from_numpy(rc.class_lut(n_ctx)).to(dev))
            extra = (n_ctx,)
        else:
            def call(raw=raw, st=st, fg=fg, cg=cg, l=l):
                return rd.rans_decode_grouped_grid(raw, st, fg, cg, l)
            tables, extra = (re_.pack_tables(fg, cg, dev),), ()
        alone = cs.grid_launch_alone(entry, raw, st, tables, l, g, *extra)
        out["rows"][key] = {
            "ms": cs.cuda_ms(call, REPS), "launch_ms": cs.cuda_ms(alone, REPS),
            "sha": ab.sha(call()),
            "bytes": cs.nbytes(raw) + raw.numel() + 4 * st.numel()
            + cs.nbytes(*tables), "S": raw.shape[1], "L": l, "G": g,
            "n_ctx": n_ctx}
        if n_ctx:
            # the context wrapper's table check and class LUT, by the host
            # clock (the LUT as each tree's wrapper makes it)
            lut_on = getattr(rc, "class_lut_on", None)
            out["rows"][key]["check_tables_host_ms"] = cs.host_ms(
                lambda: rc._check_tables(fg, cg), REPS)
            out["rows"][key]["class_lut_host_ms"] = cs.host_ms(
                (lambda: lut_on(n_ctx, dev)) if lut_on else
                (lambda: torch.from_numpy(rc.class_lut(n_ctx)).to(dev)), REPS)
    if kernels_only:
        return out

    _, frames = cs.clip_frames()
    x = torch.from_numpy(frames).to(dev)
    px = x.permute(0, 3, 1, 2)
    lanes0, s_streams, cw = cs.grid_lanes_of(dk.fused_cdct_quantize(
        px, dk.static_mat(color_ops.YCOCG_FWD), grid_layout=True))
    fg, cg, _ = cs.grid_tables(dev, lanes0)
    encode_dev, decode_dev = cs.grid_clip_route(
        dev, fg, cg, lanes0.shape[0], s_streams, cw, *frames.shape[:3])[:2]
    raw4f, st4f = encode_dev(x)
    out["paths"]["4f"] = {
        "device_decode_ms": cs.cuda_ms(lambda: decode_dev(raw4f, st4f), 5),
        "sha": ab.sha(raw4f, st4f, decode_dev(raw4f, st4f))}
    clip = test_video(cs.FRAMES, cs.H, cs.W, seed=7)
    with ab.quiet():
        _, gops, encode_full, decode_full, _, _ = cs.ipp_grid_route(dev, clip)
    _, mvs, raw, st = encode_full(gops)
    out["paths"]["4g"] = {
        "decode_ms": cs.cuda_ms(lambda: decode_full(raw, st, mvs), 5),
        "sha": ab.sha(mvs, raw, st, decode_full(raw, st, mvs))}
    return out


def ptxas_report(report: str) -> dict:
    """ptxas -v's registers, spills and shared memory of each
    rans_grid_decode_kernel<CTX, SMEM> instance."""
    rows, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(_ZN3vcf23rans_grid_decode_"
                      r"kernelILb(\d)ELb(\d)E\w*)'", line)
        if m:
            name = (f"rans_grid_decode_kernel<{'CTX' if m.group(2) == '1' else 'ORDER0'}, "
                    f"{'SMEM' if m.group(3) == '1' else 'GLOBAL'}>")
            rows[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rows[name]["spill_stores"] = int(m.group(1))
            rows[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            rows[name]["smem"] = int(sm.group(1)) if sm else 0
    return rows


def variant_rows(cs, names) -> list:
    """Each variant of csrc/rans_grid.cu built into a library of its own
    (nvcc, the package's flags, under _ab/), launched alone on the same
    inputs and tables as the current build, in turns; exact variants'
    outputs held equal to the current build's."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from vcf_tpu_torch.ops.cuda import _build
    from vcf_tpu_torch.ops.cuda import rans_ctx as rc
    from vcf_tpu_torch.ops.cuda import rans_encode as re_

    csrc = os.path.join(ab.ROOT, "vcf_tpu_torch", "csrc")
    sigs = {e: _build._SIGNATURES[e] for e in ("vcf_rans_decode_grid",
                                               "vcf_rans_decode_ctx_grid")}
    def parts(name):   # "a+b": the edits of a and of b
        return [VARIANTS[p] for p in name.split("+")]

    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(lambda n: ab.build_lib(
            f"grid_{n}", csrc, "rans_grid.cu", also=("rans_common.cuh",),
            edits=[e for _, ed in parts(n) for e in ed],
            signatures=sigs)[0], names)))
    dev = torch.device("cuda", 0)
    with ab.quiet():
        inputs = kernel_inputs(cs, dev)
    lines = []
    for key, (entry, raw, st, fg, cg, l, n_ctx) in inputs.items():
        tables = ((rc.cum_rows(fg, cg, dev), rc.class_lut_on(n_ctx, dev))
                  if n_ctx else (re_.pack_tables(fg, cg, dev),))
        extra = (n_ctx,) if n_ctx else ()
        cur = cs.grid_launch_alone(entry, raw, st, tables, l, fg.shape[0],
                                   *extra)
        cur()
        bnd = cs.bound(cs.nbytes(raw) + raw.numel() + 4 * st.numel()
                       + cs.nbytes(*tables))
        for name, lib in libs.items():
            other = cs.grid_launch_alone(entry, raw, st, tables, l,
                                         fg.shape[0], *extra, lib=lib)
            other()
            exact = all(ex for ex, _ in parts(name))
            if exact:
                cs.require(torch.equal(other.out, cur.out)
                           and int(other.err) == int(cur.err) == 0,
                           f"{key}: variant {name}'s output differs")
            t = ab.turns(other, cur, REPS)
            row = {"grid": key, "variant": name, "exact": exact, **bnd,
                   f"{name}_launch_ms": t["other"],
                   "current_launch_ms": t["current"],
                   f"{name}_x_bound": [v / bnd["bound_ms"]
                                       for v in t["other"]]}
            print(json.dumps(row), flush=True)
            lines.append(row)
    return lines


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--variants", nargs="*", default=[],
                    help=f"names of {sorted(VARIANTS)}, or a+b for both")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--kernels-only", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--time", help=argparse.SUPPRESS)  # one timing run
    args = ap.parse_args()
    if args.time:
        print(json.dumps(time_tree(args.time, args.kernels_only)), flush=True)
        return
    sys.path.insert(0, ab.ROOT)
    import chip_smoke as cs

    cs.phase_device()   # no card: exits; else prints its name and limit
    sys.stdout.flush()
    if args.ptxas:
        _, report = ab.build_lib(
            "ptxas", os.path.join(ab.ROOT, "vcf_tpu_torch", "csrc"),
            "rans_grid.cu", also=("rans_common.cuh",),
            flags=("-Xptxas", "-v"))
        print(json.dumps({"ptxas": ptxas_report(report)}), flush=True)
    lines = variant_rows(cs, args.variants) if args.variants else []
    flags = ["--kernels-only"] if args.kernels_only else []
    if args.parent:
        root = os.path.abspath(args.parent)
        runs = ab.run_in_turns(__file__, [root, ab.ROOT, ab.ROOT, root]
                               * args.rounds, args=flags)
        # in the order they ran: the parent's first and last turns of each
        # round, the current tree's middle two
        theirs = [r for i, r in enumerate(runs) if i % 4 in (0, 3)]
        mine = [r for i, r in enumerate(runs) if i % 4 in (1, 2)]
        for key, first in runs[0]["rows"].items():
            cs.require(len({r["rows"][key]["sha"] for r in runs}) == 1,
                       f"{key}: the parent tree's output differs")
            bnd = cs.bound(first["bytes"])
            row = {"grid": key, **{k: first[k] for k in
                                   ("S", "L", "G", "n_ctx")}, **bnd,
                   "bit_identical_to_parent": True}
            for who, rs in (("parent", theirs), ("current", mine)):
                for k in ("ms", "launch_ms"):
                    ms = [r["rows"][key][k] for r in rs]
                    row[f"{who}_{k}"] = ms
                    row[f"{who}_{k}_x_bound"] = [t / bnd["bound_ms"]
                                                 for t in ms]
                for k in ("check_tables_host_ms", "class_lut_host_ms"):
                    if k in first:
                        row[f"{who}_{k}"] = [r["rows"][key][k] for r in rs]
            print(json.dumps(row), flush=True)
            lines.append(row)
        for path in runs[0]["paths"]:
            cs.require(len({r["paths"][path]["sha"] for r in runs}) == 1,
                       f"phase {path}: the parent tree's output differs")
            row = {"path": path, "bit_identical_to_parent": True}
            for who, rs in (("parent", theirs), ("current", mine)):
                for k in rs[0]["paths"][path]:
                    if k != "sha":
                        row[f"{who} {k}"] = [r["paths"][path][k] for r in rs]
            print(json.dumps(row), flush=True)
            lines.append(row)
    ab.write_json(lines, args.out)


if __name__ == "__main__":
    main()
