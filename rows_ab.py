"""A/B of K2's row mode (csrc/rans_encode.cu `compact_rows_kernel`, the
wrapper `rans_compact_rows`) through each tree's own wrappers, on one
GPU: the current tree against another commit's tree and against source
variants.

    git archive <commit> | tar -x -C _ab/parent
    python3 rows_ab.py [--parent _ab/parent] [--variants prefetch ...] \
        [--rounds N] [--ptxas] [--out rows_ab.json]

Each tree runs in a process of its own that imports that tree's
vcf_tpu_torch (--parent: another commit's tree, unpacked under the
git-ignored _ab/; a variant: a copy of the current package with one
source edit, made under _ab/), builds its kernels and times, by CUDA
events after a warm-up:

- the row mode on phase 3e's raw grid (K1 on the lane-grid lanes of
  chip_smoke.py's 8 frames: S = 65536, L = 765, about 1% of the entries
  flagged) and on a grid of the same shape with half of the entries
  flagged (the stores' worst case is all of them), 20 calls each: as
  called, queued behind a sleeping kernel (the device's time alone) and
  the host's time to issue one call;
- phase 4f's wire encode (B3 grid, laning, K1, the row mode,
  `assemble_stream`), 5 calls.

Only each row's prefix is defined, so a row's hash covers its prefix and
the counts.  It prints one JSON line: the times and a SHA-256 of every
output.  The runs go in turns, (other, current, current, other),
`--rounds` times for each other tree, and every output of every run must
hash alike (bit for bit).  One JSON line a row follows, the card's name
and power limit first: each tree's times and, for the kernel rows, the
bound (chip_smoke.py's: the grid and counts once, 2 bytes a word) and the
multiples of it.  `--ptxas` first compiles the current rans_encode.cu
with `-Xptxas -v` and prints the row kernel's registers and spills.
Variants (all exact): vecs2 (2 loads a thread a round), threads256
(256-thread CTAs, 4 an SM), prefetch (the next round loaded into
registers before this one is ranked).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

import ab_common as ab

REPS = 20
ENCODE = "csrc/rans_encode.cu"
VARIANTS = {
    "vecs2": [(ENCODE, "constexpr int ROW_VECS = 4;",
               "constexpr int ROW_VECS = 2;")],
    "threads256": [(ENCODE, "constexpr int ROW_THREADS = 128;",
                    "constexpr int ROW_THREADS = 256;"),
                   (ENCODE, "constexpr int ROW_MIN_BLOCKS = 8;",
                    "constexpr int ROW_MIN_BLOCKS = 4;")],
    "prefetch": [(ENCODE, """  int run = 0;
  for (int r0 = 0; r0 < S; r0 += ROW_ROUND) {
    alignas(16) int32_t cur[ROW_VECS * CMP_VEC];
    rows_load(cur, in, r0, S, vec);""", """  int run = 0;
  alignas(16) int32_t nxt[ROW_VECS * CMP_VEC];
  rows_load(nxt, in, 0, S, vec);
  for (int r0 = 0; r0 < S; r0 += ROW_ROUND) {
    alignas(16) int32_t cur[ROW_VECS * CMP_VEC];
#pragma unroll
    for (int i = 0; i < ROW_VECS * CMP_VEC; ++i) cur[i] = nxt[i];
    rows_load(nxt, in, r0 + ROW_ROUND, S, vec);""")],
}


def prefix_sha(rows, counts) -> str:
    """The hash of each row's prefix (the rest is unspecified) and the
    counts."""
    import torch

    keep = torch.arange(rows.shape[1], device=rows.device) < counts[:, None]
    return ab.sha(rows.masked_fill(~keep, 0), counts)


def time_tree(root: str) -> dict:
    """Time and hash this process's tree (see the module's docstring)."""
    cs = ab.import_tree(root)
    import torch

    from vcf_tpu_torch.ops import color as color_ops
    from vcf_tpu_torch.ops.cuda import dct_kernel as dk
    from vcf_tpu_torch.ops.cuda import rans_encode as re_

    with ab.quiet():
        dev = cs.phase_device()
        _, frames = cs.clip_frames()
    x = torch.from_numpy(frames).to(dev)
    lanes, s_streams, cw = cs.grid_lanes_of(dk.fused_cdct_quantize(
        x.permute(0, 3, 1, 2), dk.static_mat(color_ops.YCOCG_FWD),
        grid_layout=True))
    l = lanes.shape[0]
    fg, cg, _ = cs.grid_tables(dev, lanes)
    raw, _ = re_.rans_encode_grouped(lanes.t(), fg, cg)
    gen = torch.Generator(device=dev).manual_seed(3)
    half = (torch.randint(0, 1 << 17, raw.shape, device=dev, generator=gen,
                          dtype=torch.int32))
    out = {"tree": os.path.relpath(root, ab.ROOT), "rows": {}, "paths": {}}
    for what, grid in (("3e", raw), ("half flagged", half)):
        def call():
            return re_.rans_compact_rows(grid)
        rows, counts = call()
        out["rows"][what] = {
            "ms": cs.cuda_ms(call, REPS), "queued_ms": ab.queued_ms(call, REPS),
            "host_us": 1e3 * cs.issue_ms(call, REPS),
            "words": int(counts.sum()),
            "sha": prefix_sha(rows, counts)}
    _, counts0, _ = re_.rans_encode_rows(lanes.t(), fg, cg)
    cap = min(max(-(-int(counts0.max()) * 2 // 128) * 128, 128), s_streams)
    n, h, w, _ = frames.shape
    encode_wire = cs.grid_clip_route(dev, fg, cg, l, s_streams, cw, n, h,
                                     w)[2]
    words, n_words, st, counts = encode_wire(x, cap)
    out["paths"]["4f wire encode"] = {
        "ms": cs.cuda_ms(lambda: encode_wire(x, cap), 5),
        "host_ms": cs.host_ms(lambda: encode_wire(x, cap), 5),
        "sha": ab.sha(words[:int(n_words)], st, counts)}
    return out


def ptxas_rows(report: str) -> dict:
    """ptxas -v's registers and spills of compact_rows_kernel."""
    out, on = {}, False
    for line in report.splitlines():
        if "Compiling entry function" in line:
            on = "compact_rows_kernel" in line
            continue
        if not on:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out["spill_stores"], out["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out["smem"] = int(sm.group(1)) if sm else 0
            on = False
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--variants", nargs="*", default=[],
                    choices=sorted(VARIANTS))
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--time", help=argparse.SUPPRESS)  # one timing run
    args = ap.parse_args()
    if args.time:
        print(json.dumps(time_tree(args.time)), flush=True)
        return
    sys.path.insert(0, ab.ROOT)
    import chip_smoke as cs

    cs.phase_device()   # no card: exits; else prints its name and limit
    sys.stdout.flush()
    if args.ptxas:
        _, report = ab.build_lib(
            "ptxas_rows", os.path.join(ab.ROOT, "vcf_tpu_torch", "csrc"),
            "rans_encode.cu", also=("rans_common.cuh",),
            flags=("-Xptxas", "-v"))
        print(json.dumps({"ptxas": ptxas_rows(report)}), flush=True)
    l, s = 765, 65536

    def head(key, row):
        return {"shape": f"{l}x{s}", "grid": key,
                **cs.bound(4 * l * s + 4 * l + 2 * row["words"])}

    lines = ab.compare_trees(__file__, args.parent, {
        name: VARIANTS[name] for name in args.variants}, args.rounds, head)
    ab.write_json(lines, args.out)


if __name__ == "__main__":
    main()
