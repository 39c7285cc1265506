"""A/B of the motion-compensation kernel (csrc/motion.cu, mc_apply_planar
and its channel-last mode mc_apply) through each tree's own wrappers, on
one GPU: the current tree against another commit's tree and against
source variants.

    git archive <commit> | tar -x -C _ab/parent
    python3 mc_ab.py [--parent _ab/parent] [--variants funnel copy ...] \
        [--rounds N] [--ptxas] [--out mc_ab.json]

Each tree runs in a process of its own that imports that tree's
vcf_tpu_torch (--parent: another commit's tree, unpacked under the
git-ignored _ab/; a variant: a copy of the current package with one
source edit, made under _ab/), builds its kernels and times, by CUDA
events after a warm-up, on the float32 frames of chip_smoke.py's phase
3c (test_video(8, 1088, 1920, seed=7), frames 0..6, and 2 of them: the
IPP loops' launch shape):

- MC in both layouts at 7 and 2 frames, with phase 3c's random mvs in
  [-8, 8] (the frame-edge blocks pointing out of the frame) and with the
  clip's real mvs (the SAD kernel's, m=16, s=8: the background pans, so
  nearly every block shares one vector), 20 calls
  each: as called, queued behind a sleeping kernel (the device's time
  alone) and the host's time to issue one call;
- phase 4g's planar IPP GOP loop (its encode, split by chip_smoke's
  `gop_encode_split`, and its decode), 3 calls each.

It prints one JSON line: the times and a SHA-256 of every output.  The
runs go in turns, (other, current, current, other), `--rounds` times for
each other tree, and every output of every run must hash alike (bit for
bit).  One JSON line a row follows, the card's name and power limit
first: each tree's times and, for the kernel rows, the bound
(chip_smoke.py's `bound`: frames in and out and the mvs, once each) and
the multiples of it.  `--ptxas` first compiles the current motion.cu
with `-Xptxas -v` and prints the registers, spills and shared memory of
the MC kernels.  Variants: funnel (inside the frame two aligned 16-byte
loads and a select by the offset mod 4 in place of 4 scalar loads, the
first form of this design), rows32 (32 rows a CTA), warps8 (up to 8 warps
of runs a CTA), all exact; timing only (their outputs differ): copy
(every mv read as 0: the kernel as a plain copy) and novy (the vertical
displacement read as 0).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

import ab_common as ab

REPS = 20
MOTION = "csrc/motion.cu"
VARIANTS = {
    # the first form of this design: inside the frame two aligned 16-byte
    # loads and a select by the offset mod 4
    "funnel": [(MOTION, "// The vector mode.  ref and out:", """\
__device__ __forceinline__ float4 mc_load_run(const float* __restrict__ s,
                                              int a) {
  const int r = a & 3;
  const float4 lo = __ldg(reinterpret_cast<const float4*>(s + (a - r)));
  if (r == 0) return lo;
  const float4 hi = __ldg(reinterpret_cast<const float4*>(s + (a - r) + 4));
  float4 o;
  o.x = r == 1 ? lo.y : r == 2 ? lo.z : lo.w;
  o.y = r == 1 ? lo.z : r == 2 ? lo.w : hi.x;
  o.z = r == 1 ? lo.w : r == 2 ? hi.x : hi.y;
  o.w = r == 1 ? hi.x : r == 2 ? hi.y : hi.z;
  return o;
}

// The vector mode.  ref and out:"""),
               (MOTION, """        const float* s = src + (size_t)min(max(y + vy, 0), H - 1) * row + a;
        *reinterpret_cast<float4*>(dst + (size_t)y * row) =
            make_float4(__ldg(s), __ldg(s + 1), __ldg(s + 2), __ldg(s + 3));""",
                """        *reinterpret_cast<float4*>(dst + (size_t)y * row) = mc_load_run(
            src + (size_t)min(max(y + vy, 0), H - 1) * row, a);""")],
    "rows32": [(MOTION, "constexpr int MC_VEC_ROWS = 16;",
                "constexpr int MC_VEC_ROWS = 32;")],
    "warps8": [(MOTION, "constexpr int MC_VEC_WARPS = 4;",
                "constexpr int MC_VEC_WARPS = 8;")],
    # timing only (wrong outputs): the same kernel as a plain copy (every
    # mv read as 0), and without the vertical displacement
    "copy": [(MOTION, "const int vy = __ldg(v), vx = __ldg(v + 1);",
              "const int vy = 0 * __ldg(v), vx = 0 * __ldg(v + 1);")],
    "novy": [(MOTION, "const int vy = __ldg(v), vx = __ldg(v + 1);",
              "const int vy = 0 * __ldg(v), vx = __ldg(v + 1);")],
}
TIMING_ONLY = ("copy", "novy")


def inputs(cs, dev) -> dict:
    """Phase 3c's frames (7, 3, H, W) and its mvs: "random" (seeded, in
    [-8, 8], the edge blocks pointing out of the frame) and "real" (the
    SAD kernel's on the clip's 7 luma pairs)."""
    import numpy as np
    import torch

    from vcf_tpu_torch.io import test_video
    from vcf_tpu_torch.ops import motion
    from vcf_tpu_torch.ops.cuda import sad_kernel as sk

    with ab.quiet():
        clip = test_video(cs.FRAMES, cs.H, cs.W, seed=7)
    x = torch.from_numpy(clip).to(dev)
    frames = x[:-1].permute(0, 3, 1, 2).to(torch.float32).contiguous()
    g, m, s = frames.shape[0], cs.ME_BLOCK, cs.SEARCH
    rng = np.random.default_rng(5)
    mv = rng.integers(-s, s + 1, (g, cs.H // m, cs.W // m, 2)).astype(np.int32)
    mv[:, 0, :, 0], mv[:, -1, :, 0] = -s, s
    mv[:, :, 0, 1], mv[:, :, -1, 1] = -s, s
    luma = motion.to_luma(x)
    real, _ = sk.sad_search(luma[:-1].contiguous(), luma[1:].contiguous(), m,
                            s)
    return frames, {"random": torch.from_numpy(mv).to(dev), "real": real}


def time_tree(root: str) -> dict:
    """Time and hash this process's tree (see the module's docstring)."""
    cs = ab.import_tree(root)
    import torch

    from vcf_tpu_torch.io import test_video
    from vcf_tpu_torch.ops.cuda import mc_kernel as mk

    with ab.quiet():
        dev = cs.phase_device()
    frames, mvs = inputs(cs, dev)
    frames_cl = frames.permute(0, 2, 3, 1).contiguous()
    out = {"tree": os.path.relpath(root, ab.ROOT), "rows": {}, "paths": {}}
    for n in (frames.shape[0], 2):
        for layout, fn, x in (("planar", mk.mc_apply_planar, frames),
                              ("channel-last", mk.mc_apply, frames_cl)):
            for what, mv in mvs.items():
                xn, mvn = x[:n], mv[:n].contiguous()

                def call():
                    return fn(xn, mvn, cs.ME_BLOCK)
                out["rows"][f"{layout}|{what}|{n}"] = {
                    "ms": cs.cuda_ms(call, REPS),
                    "queued_ms": ab.queued_ms(call, REPS),
                    "host_us": 1e3 * cs.issue_ms(call, REPS),
                    "sha": ab.sha(call())}
    with ab.quiet():
        clip = test_video(cs.FRAMES, cs.H, cs.W, seed=7)
        ipp, gops, encode_full, decode_full, _, _ = cs.ipp_grid_route(dev,
                                                                      clip)
        enc, dec = ipp._gop_encode_grid_batch, ipp._gop_decode_grid_batch
        planes, mv_g = enc(gops)
        split, _ = cs.gop_encode_split(enc, gops)
    out["paths"]["4g"] = {
        "encode: GOP loop": cs.cuda_ms(lambda: enc(gops), 3),
        "decode: GOP loop": cs.cuda_ms(lambda: dec(planes, mv_g), 3),
        "split": split, "sha": ab.sha(planes, mv_g, dec(planes, mv_g))}
    return out


def ptxas_mc(report: str) -> dict:
    """ptxas -v's registers, spills and shared memory of the MC kernels."""
    rows, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(_ZN3vcf\w*mc_\w+)'", line)
        if m:
            name = m.group(1)
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
            name = None
    return rows


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
            "ptxas_mc", os.path.join(ab.ROOT, "vcf_tpu_torch", "csrc"),
            "motion.cu", flags=("-Xptxas", "-v"))
        print(json.dumps({"ptxas": ptxas_mc(report)}), flush=True)

    def head(key, _):
        layout, what, n = key.split("|")
        n_el = int(n) * 3 * cs.H * cs.W
        n_mv = int(n) * (cs.H // cs.ME_BLOCK) * (cs.W // cs.ME_BLOCK) * 2
        return {"shape": f"{n}x3x{cs.H}x{cs.W}", "layout": layout,
                "mvs": what, **cs.bound(8 * n_el + 4 * n_mv)}

    lines = ab.compare_trees(__file__, args.parent, {
        name: VARIANTS[name] for name in args.variants}, args.rounds, head,
        TIMING_ONLY)
    ab.write_json(lines, args.out)


if __name__ == "__main__":
    main()
