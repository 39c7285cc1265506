"""A/B of the rANS encode kernel K1 (csrc/rans_encode.cu) against other
builds of its source, on one GPU.

    git archive <commit> vcf_tpu_torch/csrc | tar -x -C _ab/parent
    python3 encode_ab.py --parent _ab/parent/vcf_tpu_torch/csrc \
        [--variants rcp nodiv] [--out encode_ab.json]

--parent names a directory holding another commit's rans_encode.cu and
rans_common.cuh (`_ab/` is git-ignored, so the copy is never committed).
Each other build (that source, and each variant: the current source with
one edit) is compiled by nvcc with the package's flags into a library of
its own under _ab/, beside the package's own build.  On the inputs of
chip_smoke.py's phases 3 (S=65536, L=765, G=64, order 0), 3d (4 and 15
classes) and 4e (the DWT frame's grid, S=8704, L=3060, G=17: order 0 for
grans, 4 classes for cgrans), every build's K1 is launched on the same
(L, S) symbols and packed tables: the parent's raw grid and states must
equal the current build's bit for bit, and the launches alone are timed
by CUDA events in turns (other, current, current, other; 20 launches
each).  One JSON line per shape, the card's name and power limit first.
Variants:

- rcp (exact, held bit for bit against the current build): the quotient
  from a multiply-high of x by m = floor((2^32 - 1) / f), which is within
  1 of 2^32 / f, so the estimate is q or q - 1 and one correction follows;
  m depends on f alone and is taken each step;
- nodiv (timing only; its output is wrong): the quotient x / f replaced
  by a multiply-high of x by the table entry, so the chain keeps its
  shape without the division sequence.
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
ENCODE = "rans_encode.cu"
VARIANTS = {
    "rcp": [("""  const uint32_t q = x / f;
  x = (q << K_PROB) + (x - q * f) + (e >> 16);""",
             """  const uint32_t m = 0xFFFFFFFFu / f;
  uint32_t q = __umulhi(x, m);
  uint32_t r = x - q * f;
  if (r >= f) { q += 1; r -= f; }
  x = (q << K_PROB) + r + (e >> 16);""")],
    "nodiv": [("const uint32_t q = x / f;",
               "const uint32_t q = __umulhi(x, e);")],
}
EXACT = ("parent", "rcp")   # builds whose outputs must equal the current's
REPS = 20


def build(name: str, src_dir: str, edits=()) -> ctypes.CDLL:
    """Compile src_dir's rans_encode.cu (with `edits`) under
    _ab/build_<name>/ and load it."""
    from vcf_tpu_torch.ops.cuda import _build

    entries = ("vcf_rans_encode_grouped", "vcf_rans_encode_ctx")
    return ab.build_lib(name, src_dir, ENCODE, also=("rans_common.cuh",),
                        edits=edits, signatures={
                            e: _build._SIGNATURES[e] for e in entries})[0]


def launcher(dll: ctypes.CDLL):
    """launch(sym_l, tab, lut, g, n_ctx) -> (raw, states) on `dll`'s K1,
    the arguments of ops.cuda.rans_encode.launch_encode."""
    from vcf_tpu_torch.ops.cuda import _build

    def launch(sym_l, tab, lut, g, n_ctx):
        l, s = sym_l.shape
        raw = torch.empty((l, s), dtype=torch.int32, device=sym_l.device)
        st = torch.empty(s, dtype=torch.int32, device=sym_l.device)
        stream = _build.stream_of(sym_l)
        if lut is None:
            rc = dll.vcf_rans_encode_grouped(
                sym_l.data_ptr(), tab.data_ptr(), raw.data_ptr(),
                st.data_ptr(), s, l, g, stream)
        else:
            rc = dll.vcf_rans_encode_ctx(
                sym_l.data_ptr(), tab.data_ptr(), lut.data_ptr(),
                raw.data_ptr(), st.data_ptr(), s, l, g, n_ctx, stream)
        _build.check(rc, "rans_encode (A/B build)")
        return raw, st

    return launch


def shapes(dev) -> list:
    """[(name, sym_l (L, S), packed tables, lut or None, G, n_ctx)] on the
    inputs of chip_smoke.py's phases 3, 3d and 4e."""
    import chip_smoke as cs
    from vcf_tpu_torch import Codec, CodecConfig
    from vcf_tpu_torch.entropy import dwt_device as dd
    from vcf_tpu_torch.entropy import rans
    from vcf_tpu_torch.ops.cuda import rans_ctx as rc
    from vcf_tpu_torch.ops.cuda import rans_encode as re_

    def dev_tables(fg, cg):
        f = torch.from_numpy(np.asarray(fg).astype(np.int64))
        c = torch.from_numpy(np.asarray(cg).astype(np.int64))
        return re_.pack_tables(f.reshape(-1, 256), c.reshape(-1, 256), dev)

    def lut(n_ctx):
        return torch.from_numpy(rc.class_lut(n_ctx)).to(dev) if n_ctx else None

    base, frames = cs.clip_frames()
    planes = cs.index_planes(Codec(CodecConfig(entropy="grans"), device=dev),
                             frames)
    g = 64
    s = rans.RANSCodec._pick_streams(planes.numel(), 65536)
    out = []
    lanes = rans.subband_lanes(planes, 8, s)
    fg, cg = rans.freqs_from_counts(rans.group_histograms(lanes, g)
                                    .cpu().numpy())
    out.append(("phase 3 order 0", lanes.t().contiguous(), dev_tables(fg, cg),
                None, g, 0))
    lanes_c = rans.subband_lanes_ctx(planes, 8, s)
    for n_ctx in (4, 15):
        fg, cg = rans.ctx_freqs_from_counts(
            rans.ctx_group_histograms(lanes_c, g, n_ctx).cpu().numpy())
        out.append((f"phase 3d {n_ctx} classes", lanes_c.t().contiguous(),
                    dev_tables(fg, cg), lut(n_ctx), g, n_ctx))
    for ent in ("grans", "cgrans"):
        codec = Codec(CodecConfig(spatial="dwt", qss=cs.DWT_QSS, entropy=ent),
                      device=dev)
        cstream = codec.encode(base)
        gg, sg, l, *_, fg, cg, n_ctx = dd.unpack_model(cstream["gdwt_model"])
        grid = dd.bands_to_grid(codec._dwt._grid_bands(codec, base), sg, l)
        out.append((f"4e DWT grid {ent}", grid.t().contiguous(),
                    dev_tables(fg, cg), lut(n_ctx), gg, n_ctx))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--variants", nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args()
    import chip_smoke as cs
    from vcf_tpu_torch.ops.cuda import _build
    from vcf_tpu_torch.ops.cuda import rans_encode as re_

    dev = cs.phase_device()   # no card: exits; else prints name and limit
    _build.load()
    others = {"parent": launcher(build("parent", args.parent))}
    src = os.path.join(ab.ROOT, "vcf_tpu_torch", "csrc")
    for name in args.variants:
        others[name] = launcher(build(name, src, VARIANTS[name]))
    lines = []
    for what, sym_l, tab, lut, g, n_ctx in shapes(dev):
        def cur():
            return re_.launch_encode(sym_l, tab, lut, g, n_ctx)
        raw, st = cur()
        row = {"shape": what, "S": sym_l.shape[1], "L": sym_l.shape[0],
               "G": g, "n_ctx": n_ctx,
               "plan": list(re_.encode_plan(sym_l.shape[1], g, n_ctx))}
        for name, launch in others.items():
            def other():
                return launch(sym_l, tab, lut, g, n_ctx)
            if name in EXACT:
                raw_o, st_o = other()
                cs.require(torch.equal(raw, raw_o) and torch.equal(st, st_o),
                           f"{what}: K1 differs from the {name} build")
                row[f"bit_identical_to_{name}"] = True
            t = ab.turns(other, cur, REPS)
            row[f"{name}_ms"] = t["other"]
            row[f"current_ms_vs_{name}"] = t["current"]
        print(json.dumps(row), flush=True)
        lines.append(row)
    ab.write_json(lines, args.out)


if __name__ == "__main__":
    main()
