"""A/B of the block-DCT kernels (csrc/dct.cu, B1-B4) through their
wrappers, on one GPU: the current tree against another commit's tree and
against source variants.

    git archive <commit> | tar -x -C _ab/parent
    python3 dct_ab.py [--parent _ab/parent] [--variants inv64] \
        [--rounds N] [--ptxas] [--out dct_ab.json]

Each tree runs in a process of its own that imports that tree's
vcf_tpu_torch (--parent: another commit's tree, unpacked under the
git-ignored _ab/; a variant: a copy of the current package with one
source edit, made under _ab/), builds its kernels and times, by CUDA
events after a warm-up:

- B1 (plain and perceptual) on the YCoCg planes of chip_smoke.py's clip,
  B3 on its pixels, B2 perceptual and B4 on their outputs, through the
  wrappers (`dct_kernel.fused_*`), in the block and the grid layout, at 8
  frames (8 x 3 x 1088 x 1920, phases 3b and 3e) and 2 (the planar IPP
  loop's launch shape, phase 4g), 20 calls each: as called (at 2 frames
  the host's pace), queued behind a sleeping kernel so that they run back
  to back (the device's time alone), and the host's time to issue one
  call;
- phase 4g's planar IPP GOP loop (its encode, split by chip_smoke's
  `gop_encode_split`, and its decode; the whole encode and decode with
  rANS) and phase 4f's lane-grid clip (device-resident encode and
  decode), 3 to 5 calls each.

It prints one JSON line: the times and a SHA-256 of every output.  The
runs go in turns, (other, current, current, other), `--rounds` times for
each other tree, and every output of every run must hash alike (bit for
bit).  One JSON line a row follows, the card's name and power limit
first: each tree's times (both turns of each round), and for the kernels
the bound (chip_smoke.py's `bound`) and the multiples of it.  `--ptxas`
first compiles the current dct.cu with `-Xptxas -v` and prints the
registers, spills and shared memory of its B = 8 instances.  Variant:
inv64, the inverse kernel in CTAs of 64 threads.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

import ab_common as ab

B = 8
REPS = 20
VARIANTS = {
    "inv64": [("csrc/dct.cu", "constexpr int IDCT_THREADS = 128;",
               "constexpr int IDCT_THREADS = 64;")],
}
# mode -> (perceptual, colour): the rows of each shape and layout
MODES = {"B1": (False, False), "B1 perceptual": (True, False),
         "B3": (False, True), "B2 perceptual": (True, False),
         "B4": (False, True)}


def time_tree(root: str) -> dict:
    """Time and hash this process's tree (see the module's docstring)."""
    cs = ab.import_tree(root)
    import torch

    from vcf_tpu_torch.io import test_video
    from vcf_tpu_torch.ops import color as color_ops
    from vcf_tpu_torch.ops.cuda import dct_kernel as dk

    with ab.quiet():
        dev = cs.phase_device()
        _, frames = cs.clip_frames()
        clip = test_video(cs.FRAMES, cs.H, cs.W, seed=7)
    x = torch.from_numpy(frames).to(dev)
    px = x.permute(0, 3, 1, 2).contiguous()
    ct = color_ops.ycocg_forward(x.to(torch.float32) - 128
                                 ).permute(0, 3, 1, 2).contiguous()
    mf = dk.static_mat(color_ops.YCOCG_FWD)
    mi = dk.static_mat(color_ops.YCOCG_INV)
    out = {"tree": os.path.relpath(root, ab.ROOT), "rows": {}, "paths": {}}
    for n in (cs.FRAMES, 2):
        for layout in ("block", "grid"):
            kw = dict(b=B, grid_layout=layout == "grid")
            pxn, ctn = px[:n], ct[:n]
            k1p = dk.fused_dct_quantize(ctn, perceptual=True, **kw)
            k3 = dk.fused_cdct_quantize(pxn, mf, **kw)
            calls = {
                "B1": lambda: dk.fused_dct_quantize(ctn, **kw),
                "B1 perceptual": lambda: dk.fused_dct_quantize(
                    ctn, perceptual=True, **kw),
                "B3": lambda: dk.fused_cdct_quantize(pxn, mf, **kw),
                "B2 perceptual": lambda: dk.fused_dequantize_idct(
                    k1p, perceptual=True, **kw),
                "B4": lambda: dk.fused_dequantize_cdct(k3, mi, **kw)}
            for mode, fn in calls.items():
                out["rows"][f"{mode}|{layout}|{n}"] = {
                    "ms": cs.cuda_ms(fn, REPS), "queued_ms": ab.queued_ms(fn),
                    "host_us": 1e3 * cs.issue_ms(fn),
                    "sha": ab.sha(fn())}

    ipp, gops, encode_full, decode_full, _, _ = cs.ipp_grid_route(dev, clip)
    enc, dec = ipp._gop_encode_grid_batch, ipp._gop_decode_grid_batch
    planes, mvs, raw, st = encode_full(gops)
    with ab.quiet():
        split, _ = cs.gop_encode_split(enc, gops)
    out["paths"]["4g"] = {
        "encode: GOP loop": cs.cuda_ms(lambda: enc(gops), 3),
        "decode: GOP loop": cs.cuda_ms(lambda: dec(planes, mvs), 3),
        "encode_ms": cs.cuda_ms(lambda: encode_full(gops), 3),
        "decode_ms": cs.cuda_ms(lambda: decode_full(raw, st, mvs), 3),
        "split": split,
        "sha": ab.sha(planes, mvs, raw, st, decode_full(raw, st, mvs))}

    lanes0, s_streams, cw = cs.grid_lanes_of(dk.fused_cdct_quantize(
        px, mf, grid_layout=True))
    fg, cg, _ = cs.grid_tables(dev, lanes0)
    encode_dev, decode_dev = cs.grid_clip_route(
        dev, fg, cg, lanes0.shape[0], s_streams, cw, *frames.shape[:3])[:2]
    raw4f, st4f = encode_dev(x)
    out["paths"]["4f"] = {
        "device_encode_ms": cs.cuda_ms(lambda: encode_dev(x), 5),
        "device_decode_ms": cs.cuda_ms(lambda: decode_dev(raw4f, st4f), 3),
        "sha": ab.sha(raw4f, st4f, decode_dev(raw4f, st4f))}
    return out


def ptxas_b8(report: str) -> dict:
    """ptxas -v's registers, spills and shared memory of each
    dct_{forward,inverse}_kernel<COLOR, 8, GRID> instance."""
    rows, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(_ZN3vcf\d+dct_(forward|"
                      r"inverse)_kernelILb(\d)ELi(\d+)ELb(\d)E\w*)'", line)
        if m:
            kind, color, b, grid = m.group(2, 3, 4, 5)
            name = None
            if int(b) == B:
                mode = "COLOR" if color == "1" else "PLANES"
                layout = "grid" if grid == "1" else "block"
                name = f"dct_{kind}_kernel<{mode}, {b}, {layout}>"
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


def kernel_bound(cs, key: str) -> dict:
    """chip_smoke's bound of a kernel row: u8 or f32 planes in and out,
    the DCT's operations a value."""
    mode, _, n = key.split("|")
    perceptual, colour = MODES[mode]
    n_el = int(n) * 3 * cs.H * cs.W
    n_bytes = n_el * (2 if colour else 5)
    return cs.bound(n_bytes, n_el * cs.dct_ops_per_elem(
        B, perceptual, color=colour))


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
            "ptxas", os.path.join(ab.ROOT, "vcf_tpu_torch", "csrc"),
            "dct.cu", flags=("-Xptxas", "-v"))
        print(json.dumps({"ptxas": ptxas_b8(report)}), flush=True)

    def head(key, _):
        mode, layout, n = key.split("|")
        return {"shape": f"{n}x3x{cs.H}x{cs.W}", "mode": mode,
                "layout": layout, **kernel_bound(cs, key)}

    lines = ab.compare_trees(__file__, args.parent, {
        name: VARIANTS[name] for name in args.variants}, args.rounds, head)
    ab.write_json(lines, args.out)


if __name__ == "__main__":
    main()
