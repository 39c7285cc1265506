"""A/B of the SAD search kernel (csrc/motion.cu) against other builds of
its source, on one GPU.

    git archive <commit> vcf_tpu_torch/csrc | tar -x -C _ab/parent
    python3 sad_ab.py --parent _ab/parent/vcf_tpu_torch/csrc \
        [--variants r17 warp_only thread_only] [--out sad_ab.json]

--parent names a directory holding another commit's motion.cu (`_ab/` is
git-ignored, so the copy is never committed); that build's
`vcf_sad_search` takes no refinement counter (the first design's entry).
Each other build (that source, and each variant: the current source with
one edit) is compiled by nvcc with the package's flags into a library of
its own under _ab/.  Lumas (m=16, s=8 unless stated): chip_smoke.py's
phase 3c clip (test_video(8, 1088, 1920, seed=7): ref = frames 0..6, cur
= frames 1..7) and its first 2 frames (the IPP loops' launch shape), the
same at s=4, a fade and a half-flat clip made from it (`clips`), and the
screen's worst case (2 flat frames, the second 3.25 brighter: every
displacement ties and is summed again in float64).  On each, every
build's kernel runs on the same lumas: its mvs and SADs must equal the
current build's bit for bit, and the launches are timed by CUDA events in
turns (other, current, current, other; 20 launches each).  One JSON line
per shape, the card's name and power limit first, with the current
build's count of screened displacements summed again in float64 and of
CTAs that summed them a thread an item.  Variants (all exact):

- r17: runs of 17 dx at every range (no instances with runs of 9);
- warp_only / thread_only: every CTA sums its listed candidates a warp an
  item / a thread an item, whatever the list's length;
- screen_only (timing only; its output is wrong): the kernel ends after
  the float32 sums (staging and the screen's loop alone).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import numpy as np
import torch

import ab_common as ab

sys.path.insert(0, ab.ROOT)
MOTION = "motion.cu"
VARIANTS = {
    "r17": [("  return r_long <= r_short ? SAD_RUN_LONG : SAD_RUN_SHORT;",
             "  return SAD_RUN_LONG;")],
    "warp_only": [("constexpr int SAD_THREAD_LIST = 64;",
                   "constexpr int SAD_THREAD_LIST = 1 << 30;")],
    "thread_only": [("constexpr int SAD_THREAD_LIST = 64;",
                     "constexpr int SAD_THREAD_LIST = 1;")],
    "screen_only": [("  __syncthreads();\n\n  const double inf",
                     "  __syncthreads();\n"
                     "  if (s_f[(threadIdx.x * 7) % (items * R)] == -1.0f) "
                     "sad[0] = 1.0f;\n  if (s >= 0) return;\n\n"
                     "  const double inf")],
}
# variants whose outputs are wrong by design (timing only)
TIMING_ONLY = ("screen_only",)
REPS = 20
_P, _I = ctypes.c_void_p, ctypes.c_int
# the first design's entry: no refinement counter
PARENT_SIGNATURE = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]


def build(name: str, src_dir: str, edits=()) -> ctypes.CDLL:
    """Compile src_dir's motion.cu (with `edits`) under _ab/build_<name>/
    and load it."""
    from vcf_tpu_torch.ops.cuda import _build

    return ab.build_lib(name, src_dir, MOTION, edits=edits, signatures={
        "vcf_sad_search": PARENT_SIGNATURE if name == "parent"
        else _build._SIGNATURES["vcf_sad_search"]})[0]


def launcher(dll: ctypes.CDLL, parent: bool):
    """launch(ref, cur, m, s) -> (mv, sad) on `dll`'s kernel."""
    from vcf_tpu_torch.ops.cuda import _build

    def launch(ref, cur, m, s):
        g, h, w = cur.shape
        mv = torch.empty((g, h // m, w // m, 2), dtype=torch.int32,
                         device=cur.device)
        sad = torch.empty((g, h // m, w // m), dtype=torch.float32,
                          device=cur.device)
        args = [ref.data_ptr(), cur.data_ptr(), mv.data_ptr(),
                sad.data_ptr()] + ([] if parent else [None])
        rc = dll.vcf_sad_search(*args, g, h, w, m, s, _build.stream_of(cur))
        _build.check(rc, "vcf_sad_search (A/B build)")
        return mv, sad

    return launch


def clips(frames: np.ndarray) -> dict:
    """uint8 clips built from `frames` (N, H, W, 3): the clip itself, a fade
    (frame k scaled by 1 - 0.08 k) and a half-flat clip (the top half a
    flat sky brightening by 2 levels a frame, as under a change of light)."""
    k = np.arange(len(frames), dtype=np.float32)[:, None, None, None]
    fade = np.round(frames * (1 - 0.08 * k)).astype(np.uint8)
    half = frames.copy()
    for i in range(len(half)):
        half[i, : half.shape[1] // 2] = (110 + 2 * i, 150 + 2 * i,
                                         200 + 2 * i)
    return {"": frames, "fade ": fade, "half flat ": half}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--variants", nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args()
    import chip_smoke as cs
    from vcf_tpu_torch.io import test_video
    from vcf_tpu_torch.ops import motion
    from vcf_tpu_torch.ops.cuda import sad_kernel as sk

    dev = cs.phase_device()   # no card: exits; else prints name and limit
    others = {"parent": launcher(build("parent", args.parent), True)}
    src = os.path.join(ab.ROOT, "vcf_tpu_torch", "csrc")
    for name in args.variants:
        others[name] = launcher(build(name, src, VARIANTS[name]), False)
    m, s = cs.ME_BLOCK, cs.SEARCH
    n, h, w = cs.FRAMES, cs.H, cs.W
    shapes = []
    for what, frames in clips(test_video(n, h, w, seed=7)).items():
        luma = motion.to_luma(torch.from_numpy(frames).to(dev))
        shapes += [(f"{what}{n - 1}x{h}x{w}", luma[:-1], luma[1:], s),
                   (f"{what}2x{h}x{w}", luma[:2], luma[1:3], s)]
        if not what:
            shapes.append((f"{n - 1}x{h}x{w} s=4", luma[:-1], luma[1:], 4))
    # the screen's worst case: a flat frame under a brightness change,
    # where every displacement ties and is summed again
    flat = torch.full((2, h, w), 37.114, dtype=torch.float32, device=dev)
    shapes.append((f"2x{h}x{w} flat + 3.25", flat, flat + 3.25, s))
    lines = []
    for what, ref, cur, s in shapes:
        ref, cur = ref.contiguous(), cur.contiguous()

        def current():
            return sk.sad_search(ref, cur, m, s)
        mv, sad, n_ref, n_thread = sk.count_refined(ref, cur, m, s)
        row = {"shape": what, "m": m, "s": s,
               "refined": n_ref, "thread_ctas": n_thread,
               "displacements": mv[..., 0].numel() * (2 * s + 1) ** 2}
        for name, launch in others.items():
            def other():
                return launch(ref, cur, m, s)
            mv_o, sad_o = other()
            if name not in TIMING_ONLY:
                cs.require(torch.equal(mv, mv_o) and torch.equal(sad, sad_o),
                           f"{row['shape']}: the {name} build differs")
                row[f"bit_identical_to_{name}"] = True
            t = ab.turns(other, current, REPS)
            row[f"{name}_ms"] = t["other"]
            row[f"current_ms_vs_{name}"] = t["current"]
        print(json.dumps(row), flush=True)
        lines.append(row)
    ab.write_json(lines, args.out)


if __name__ == "__main__":
    main()
