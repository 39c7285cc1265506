"""A/B of source variants of the look-back kernels (K2, K3) on one GPU.

    python3 lookback_ab.py [--variants lanes256 no_abort ...]

Copies vcf_tpu_torch into _ab/<variant>/ with one source edit per
variant, then runs chip_smoke.py's phases 3 and 3d (K1-K3 and their
context modes at S=65536, L=765, G=64, each bit-exact against its plain
version) on the shipped package and on each variant in turns (shipped,
variant, variant, shipped), each run in a process of its own that builds
its own kernels.  Each run prints one JSON line of the phases' CUDA-event
ms (the phases' own log goes to stderr).  Variants:

- acq_rel: descriptors published with st.release.gpu and read with
  ld.acquire.gpu instead of relaxed GPU-scope accesses;
- k2_no_min_blocks: K2 without its __launch_bounds__ minimum of 8 blocks
  an SM;
- lanes256, lanes512: K3's look-back blocks of 256 or 512 lanes instead
  of 128;
- no_abort: K3's look-back spins without polling the abort flag.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import ab_common as ab

COMMON = "csrc/rans_common.cuh"
DECODE = "csrc/rans_decode.cu"
ENCODE = "csrc/rans_encode.cu"
LANES = "constexpr int LB_LANES = 128;"
VARIANTS = {
    "acq_rel": [
        (COMMON, "ld.relaxed.gpu.global.u64", "ld.acquire.gpu.global.u64"),
        (COMMON, "st.relaxed.gpu.global.u64", "st.release.gpu.global.u64")],
    "k2_no_min_blocks": [
        (ENCODE, "__launch_bounds__(CMP_THREADS, 8)\ncompact_kernel",
         "__launch_bounds__(CMP_THREADS)\ncompact_kernel")],
    "lanes256": [(DECODE, LANES, LANES.replace("128", "256"))],
    "lanes512": [(DECODE, LANES, LANES.replace("128", "512"))],
    "no_abort": [(DECODE, "(uint32_t)total, &hdr[1])",
                  "(uint32_t)total, nullptr)")],
}
# the keys of a kernels-line entry that a run reports
TIMES = ("ms", "ms_15_classes", "launch_ms", "launch_ms_15_classes",
         "ms_no_counts", "library_ms")


def time_package(pkg_root: str) -> dict:
    """Run phases 3 and 3d on the vcf_tpu_torch under pkg_root (this
    process); returns their kernels' times."""
    cs = ab.import_tree(pkg_root)
    from vcf_tpu_torch import Codec, CodecConfig

    with ab.quiet():
        dev = cs.phase_device()
        _, frames = cs.clip_frames()
        planes = cs.index_planes(
            Codec(CodecConfig(entropy="grans"), device=dev), frames)
        rows = cs.phase_kernels(dev, planes) + \
            cs.phase_ctx_kernels(dev, planes)[0]
    out = {"package": os.path.relpath(pkg_root, ab.ROOT)}
    for row in rows:
        out[row["name"]] = {k: row[k] for k in TIMES if row.get(k)}
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--time", help=argparse.SUPPRESS)  # one timing run
    args = ap.parse_args()
    if args.time:
        print(json.dumps(time_package(args.time)), flush=True)
        return
    sys.path.insert(0, ab.ROOT)
    import chip_smoke as cs

    cs.phase_device()   # no card: exits; else prints its name and limit
    sys.stdout.flush()
    for name in args.variants:
        variant = ab.copy_package(name, VARIANTS[name])
        for pkg in (ab.ROOT, variant, variant, ab.ROOT):
            subprocess.run([sys.executable, __file__, "--time", pkg],
                           check=True, timeout=600)


if __name__ == "__main__":
    main()
