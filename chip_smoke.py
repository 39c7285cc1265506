"""Drive the PyTorch + CUDA port (vcf_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (PATH or /usr/local/cuda/bin); builds the
kernels from vcf_tpu_torch/csrc on first use.  Phases:

1. device: the card's name and power limit; TF32 off for every matmul;
2. build: nvcc for sm_90a into vcf_tpu_torch/_build, timed;
3. rANS kernels K1-K3: each against its plain torch version on the card,
   on the index planes of 8 rolled 1088x1920 frames (S=65536 lanes,
   L=765 steps, 64 subband tables), bit-exact, with CUDA-event times of
   both; K2 (one pass) also against its three-kernel form's outputs
   (masked_select's words, torch's row sum) and timed beside
   masked_select; K1 and K3's look-back kernel (counts given) also timed
   as launches alone (tables packed before), and K3's one-block kernel
   (no counts) checked and timed;
3f. K1 in both modes (order 0, 4 and 15 classes) bit-exact against its
   plain version around its staged tile of T steps (L = 1, T - 1, T,
   T + 1, 2T + 1; S = 1100) and with 128-lane blocks spanning 65 groups
   of sg = 2, whose tables it reads from global memory;
3b. DCT kernels B1-B4 on the same 8 frames: the color-fused pair (ycocg)
   on the pixels, B1/B2 in plain and perceptual mode on the
   ycocg-transformed planes; each against its plain version under the
   +-1 rule (the share that differs is printed), with CUDA-event times;
4. main path, still: Codec(CodecConfig(entropy="grans"), device="cuda")
   encode -> container bytes -> decode of one 1088x1920 frame, and the
   grouped codec on the 8-frame batch; indexes must round-trip exactly,
   the frame must agree with the port's CPU run within the +-1 index
   rule, and K1-K3's launch counts must be > 0;
4b. main path, clip: IIICodec(VideoConfig(n_frames=8),
   CodecConfig(entropy="grans"), "cuda") encode -> bytes -> decode of the
   8 frames (one batched clip stream; K1-K3 and B3/B4 must launch; the
   BatchCodec planes agree with the per-frame Codec on the card under
   the +-1 rule; the decoded planes round-trip exactly; rmse within 1e-3
   of the port's CPU BatchCodec), then a perceptual clip of 2 frames,
   through which B1/B2 must launch;
3c. motion kernels on the lumas of test_video(8, 1088, 1920, seed=7):
   sad_search with ref = frames 0..6 and cur = frames 1..7 (m=16, s=8),
   and on 2 of those pairs (the IPP loops' launch shape, also timed),
   against its plain version (0 differing mvs, SAD max_abs_err 0), with
   the count of displacements its float32 screen sums again, and at
   s=77 on a 2x64x96 crop (past the instance's shared memory: the generic
   kernel's global mode), and
   mc_apply_planar / mc_apply (channel-last) on the (7, 3, 1088, 1920)
   float32 frames with seeded mvs in [-8, 8], the frame-edge blocks
   pointing out of the frame, and with the SAD kernel's real mvs, at 7
   and 2 frames, bit-exact, every launch in the vector mode (its Python
   mirror `launch_mode` equal to `vcf_mc_mode`); CUDA-event times of
   each (MC at 7 and 2 frames, both layouts, beside torch.take with a
   prebuilt source index, and the wrapper's host time a call); and the
   luma kernel at the planar IPP loop's launch shapes, 8x3x1088x1920
   float32 planar with the round (on half-integer pixels) and a
   (8, 1088, 1920, 3) u8 frame view of an (8, 2, 1088, 1920, 3) clip,
   bit for bit against its plain version (`to_luma`, fma_rows' chain),
   both in their vector modes, timed beside it;
3g. the DWT level kernels (csrc/dwt.cu) at the dwt_wire_8f cell's five
   db5 levels of an (8, 1088, 1920, 3) float32 clip: each level's
   analysis bands bit for bit and its synthesis equal to the plain torch
   chain (`ops.dwt.analyze_level_ref` / `synthesize_level_ref`), timed
   beside it by CUDA events, the bound each level's input and outputs
   read and written once (the row's `ms` the five analysis levels, its
   `synthesis_*` keys the five synthesis levels); and the clip path's two
   ends (csrc/dwt_ends.cu) on that clip: colour in, the quantizer into the
   lane grid, the dequantizer from K3's transposed view, colour out, each
   bit for bit against its plain torch chain and timed beside it;
4c. main path, IPP: IPPCodec(VideoConfig(mode="ipp", n_frames=8,
   gop_size=4, me_block=16, search_range=8), CodecConfig(entropy="grans",
   subbands=False), "cuda") encode -> bytes -> decode of that clip (SAD,
   MC, B1/B2 and K1-K3 must launch; the decoded index planes equal the
   encoded ones; the decoded frames equal the encoder's closed-loop
   reconstruction; rmse within 1e-2 of the port's CPU run of the whole
   clip, with the share of mv blocks and indexes that differ, and equal
   streams when none differs; SAD's launches all take its m=16
   instance and MC's its vector mode, none a generic mode), with warm
   encode/decode times and the split of each into its device loop and
   its entropy stage;
3d. the context modes of K1/K3 at S=65536, L=765, G=64 with 4 and 15
   classes, bit-exact (K3 with counts and without), each also timed as a
   launch alone; 4d: the 8-frame cgrans clip; 4e: the 1088x1920 DWT frame
   (cgrans and grans) against the port's CPU run, each encode launching
   one DWT analysis kernel a level and each decode one synthesis kernel
   a level (the `dwt_level` row's launches), and each one launch of the
   two ends of its direction (the `dwt_color_in` ... `dwt_color_out`
   rows' launches), K1 (context mode,
   order 0) bit-exact and timed on its (17*512, 3060) lane grid, and its
   device-resident context route (context encode -> rans_decode_ctx_grid
   -> synthesis), whose lanes equal the wire decode's, and the context
   grid decode on that grid bit-exact against its plain version, timed
   (wrapper and launch alone) with its plan;
3e. the lane-grid modes at full size: B1-B4 in the subband-grid layout
   (B1/B2 perceptual too) under the +-1 rule against their plain
   versions and bit-exact against the block-mode kernels' output
   permuted (B3/B4's also timed on 2 frames, phase 4g's launch shape,
   `ms_2_frames`); K1 on the (L, S) lanes' transposed view, the row mode of
   K2 and assemble_stream, the grid decode and K3 (each output's .t() is
   the (L, S) layout) on the grid lanes of the 8 frames, and the context grid decode
   on 3d's grids, each bit-exact against its plain version; the grid
   decodes also timed as launches alone, with their launch plans
   (`decode_plan`, held equal to its Python mirror);
4f. the 8-frame grans clip on the lane-grid path (bench.py's
   composition): device-resident B3 grid -> grid_lanes_lmajor -> K1 on
   lanes.t() -> grid decode .t() -> grid_unlanes_lmajor -> B4 grid, and
   the wire route (K1 + row mode -> assemble_stream -> K3 .t()); both
   give the IIICodec clip's frames bit for bit; wire bpp, rmse and
   encode/decode times of both, the wire encode split into K1, the row
   mode and assemble_stream; then a 2-frame perceptual lane-grid clip
   through the B1/B2 grid modes, equal to the perceptual IIICodec clip;
4g. IPPCodec's planar grid loop on the 4c clip (benchmarks/bench_ipp.py's
   composition): _gop_encode_grid_batch -> grid lanes -> K1 ->
   grid decode -> _gop_decode_grid_batch; decoder == encoder; mvs and
   indexes against the port's CPU run of the same loop (SAD's m=16
   instance, MC's and the luma kernel's vector modes launched); rmse,
   bpp, encode/decode times, the GOP-loop encode split by CUDA events
   into luma, SAD, MC,
   B3/B4 and the rest, and the SAD screen's second sums on the loop's
   references;
4h. the host entropy codecs and the quantizers on phase 4's frame
   (test_image(1088, 1920, seed=3)): dct_huffman, ycocg_cbaac,
   dct_lloydmax_zlib, colorvq_zlib, DCT + cbahc (8 tiles, on the frame's
   first 272 rows), the entropy-only flow with png and with pnm, DCT +
   vq, DWT + lloydmax, the quantize-only flow and DCT without a
   quantizer; each encodes on the card and on the CPU, the two streams
   are held to their rule (stored indexes: the +-1 rule and equal entropy
   bytes where they agree; k-means labels: agreement >= 0.999; the
   entropy-only flow: equal bytes), and both streams decode on both
   devices (each decode against the CPU's under the pixel rule), with
   bpp, rmse and warm host-clock ms; then the 11 goldens decode on the
   card (the count that equals the stored sha256 is printed), and an
   8-frame Lloyd-Max IIICodec clip (zlib) runs with per-frame and with
   shared levels, levels and stream equal to the CPU's;
4i. the codec compositions on phase 4's frame: KLT, MDCT and LBT (zlib,
   qss 16; LBT's default 1000 epochs), DCT with srans and with ihuff, and
   DCT (qss 64, zlib) with the gaussian, NLM and BM3D decode filters:
   each encodes and decodes the full frame on the card (bpp, rmse, warm
   host-clock ms) and is held against the port's CPU run: "index" streams
   by the +-1 rule and equal entropy bytes (srans's K1-K3 must launch),
   "trained" ones (KLT, LBT) by their weights, bpp and rmse, every stream
   decoding on both devices under the pixel rule; the filters by the
   filter rule on a crop of the card's unfiltered decode.  The CPU
   references' crops: LBT trains on its first 136x240 (on both devices),
   NLM runs on 544x960 and BM3D on 272x480.  Then the generic IPP closed
   loop (4 frames of the 4c clip, gop 4, me_block 16, search range 8,
   the DWT grans still codec) against its CPU run under C7's rule; SAD's
   m=16 instance, MC's vector mode and K1-K3 must launch.  BM3D is also
   held to ROADMAP C13's rule (no pixel past 1, at most 0.05% by 1), and
   its steps on the card against the CPU on the crop, each fed the CPU's
   input, are printed (`bm3d_stage_shares`);
4j. the entry points at full width: phase 4's frame as a PNG and the 4c
   clip as a Y4M (`io.video.write_y4m`) through `vcf_tpu_torch.cli.main`
   in this process with no --device (the card): encode, decode and rde
   with `grans`, encode and decode with DWT `cgrans`, video-encode and
   video-decode with III `grans` and with 4c's IPP configuration (-x: no
   subbands), the III decode with --preview; every file equal to the
   in-process codec's stream or decode byte for byte (IPP: 4c's own), the
   kernels each path reaches launched; the IPP decode inside
   `utils.profiling.trace` (trace size, peak allocated bytes printed);
   then `python -m vcf_tpu_torch encode ... -c grans` as a subprocess with
   no --device, its file equal to this process's, neither jax nor vcf_tpu
   imported;
4k. the distribution layer (`vcf_tpu_torch.parallel`): meshes that name
   cuda:0 several times (their shards run one after another there): the
   8-frame grans IIICodec clip on 4 shards (stream and decode equal to
   4b's; B3/B4 once a shard and K1-K3 launched), timed in turns against
   the one-device clip; the shared-levels Lloyd-Max BatchCodec on 4 shards
   (levels and planes equal to one device's); the 4c IPP clip on 2 shards
   (stream and decode equal to 4c's; SAD's m=16 instance and MC's vector
   mode); the row-sharded DWT level of phase 4's frame in 4 slabs of 272
   rows (haar, db5, bior4.4), bit for bit `analyze_level`; the sharded
   k-means on 4h's DCT + vq blocks against `kmeans` from the same init
   (centres within 1e-3, labels by agreement); one LBT step over 4 shards
   of the frame's blocks within rtol 1e-5 of the same step on the CPU;
   a world of one over NCCL (`allreduce_histogram`, `replicate` and the
   4-shard shared-levels BatchCodec through it, equal to the in-process
   results, and its start-up time); two processes of
   tests/_torch_dist_worker.py over Gloo, each coding on cuda:0 (NCCL
   refuses two ranks on one card), whose gathered streams, shared levels
   and planes equal this process's.  The card is one: no run crosses two
   cards.

Each path's launch counts are set to 0 just before it runs and read just
after.  Any failed check raises (non-zero exit, no result).  The last
two lines are one JSON object of kernel results (with each kernel's
bound: the larger of its bytes over HBM's rate and its operations over
the float32 peak, the benchmark's yardstick `portbench.core.work`) and
one of the device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from portbench.core import work

FRAMES, H, W = 8, 1088, 1920
# the +-1 index rule of the transforms: float32 sums taken in another
# order may move an index across a rounding edge, never by more than 1,
# on at most this share of entries
MAX_INDEX_DIFF, MAX_DIFF_SHARE = 1, 1e-4
# B2's float32 planes (magnitude <= 2^9) against its plain version: two
# passes of 8-term sums in another order, a few ulp of 2^-15 each
MAX_PLANE_ERR = 1e-2
PERCEPTUAL_FRAMES = 2
# the IPP configuration of benchmarks/bench_ipp.py:35-40
ME_BLOCK, SEARCH, GOP = 16, 8, 4
# GPU against CPU IPP run: the ±1 index knife edge of the transforms may
# move a reconstruction, and so the P chain after it, a little
MAX_IPP_RMSE_DIFF = 1e-2
# the DWT frame of phase 4e (the reference bench's frame, bench.py:105)
DWT_QSS, DWT_GRID = 16, (17, 512, 3060)
# the IPP closed loop's +-1 rule (ROADMAP C7): a moved index moves the P
# chain after it, so a larger share than the still codecs'
MAX_IPP_DIFF_SHARE = 5e-4
# phase 4h: a codec whose native loop passes 20 s on the full frame is run
# on the frame's first HOST_ROWS rows (CBAHC rebuilds its Huffman code
# before every symbol: ~175 s a pass at 1088x1920 on one core)
HOST_ROWS = 272
# palette / block VQ labels on the card against the CPU: an argmin over
# float32 distances whose matmul sums in another order may flip a near-tie
MIN_LABEL_AGREEMENT = 0.999
# one stream decoded on the card against the CPU: the inverse transforms'
# float order may move a pixel across a rounding edge
MAX_PIXEL_DIFF, MAX_PIXEL_SHARE = 1, 1e-3
# 4h's configurations: name, CodecConfig fields, the rule of its stored
# arrays ("index": the +-1 rule, "kmeans": label agreement, "bytes": the
# whole stream), the rows it runs on (None: all)
HOST_PHASE = (
    ("dct_huffman", dict(entropy="huffman"), "index", None),
    ("ycocg_cbaac", dict(spatial="none", color="ycocg", qss=16,
                         entropy="cbaac"), "index", None),
    ("dct_lloydmax_zlib", dict(quantizer="lloydmax", qss=32, entropy="zlib"),
     "index", None),
    ("colorvq_zlib", dict(spatial="none", color="none", quantizer="colorvq",
                          entropy="zlib", seed=1), "kmeans", None),
    ("dct_cbahc", dict(entropy="cbahc", context_tiles=8), "index", HOST_ROWS),
    ("entropy_png", dict(spatial="none", color="none", quantizer="none",
                         entropy="png"), "bytes", None),
    ("entropy_pnm", dict(spatial="none", color="none", quantizer="none",
                         entropy="pnm"), "bytes", None),
    ("dct_vq_zlib", dict(quantizer="vq", entropy="zlib"), "kmeans", None),
    ("dwt_lloydmax_zlib", dict(spatial="dwt", quantizer="lloydmax",
                               entropy="zlib"), "index", None),
    ("quantize_only", dict(spatial="none", color="none", entropy="zlib"),
     "index", None),
    ("dct_none", dict(quantizer="none", entropy="zlib"), "index", None),
)
# phase 4i (the codec compositions): name, CodecConfig fields, the rule of
# its stored arrays ("index": the +-1 rule, and equal entropy bytes where
# the indexes agree; "trained": weights, bpp and rmse within tolerances),
# the crop (rows, cols) that the CPU reference runs on (None: the frame)
LBT_CROP, NLM_CROP, BM3D_CROP = (136, 240), (544, 960), (272, 480)
FLOW_PHASE = (
    ("klt_zlib", dict(spatial="klt", qss=16, entropy="zlib"), "trained",
     None),
    ("mdct_zlib", dict(spatial="mdct", qss=16, entropy="zlib"), "index",
     None),
    ("lbt_zlib", dict(spatial="lbt", qss=16, entropy="zlib"), "trained",
     LBT_CROP),
    ("dct_srans", dict(entropy="srans"), "index", None),
    ("dct_ihuff", dict(entropy="ihuff"), "index", None),
    ("dct_gaussian", dict(qss=64, entropy="zlib", filter="gaussian"),
     "index", None),
    ("dct_nlm", dict(qss=64, entropy="zlib", filter="nlm"), "index",
     NLM_CROP),
    ("dct_bm3d", dict(qss=64, entropy="zlib", filter="bm3d"), "index",
     BM3D_CROP),
)
# the "trained" rule.  KLT: a row whose eigenvalue stands KLT_SEPARATED of
# the channel's largest apart from its neighbours moves by the covariance's
# rounding over that gap, so such rows agree within KLT_ROW_TOL (up to
# sign); the other rows are arbitrary within their near-equal group
# (ROADMAP C3) and are reported.  LBT: float32 Adam from the DCT basis
# moves its weights by up to ~0.02 under another float order (the port's
# float32 against float64 training on the LBT crop, CPU), so card and CPU
# within LBT_WEIGHT_TOL.  Both: bpp and rmse within TRAINED_RTOL (relative)
KLT_SEPARATED, KLT_ROW_TOL = 1e-3, 1e-3
LBT_WEIGHT_TOL = 0.1
TRAINED_RTOL = 0.05
# the filter rule (tests/test_torch_filters.py): the card's filter against
# the CPU's on one u8 frame, |d| <= 1 but on at most FILTER_SHARE of the
# pixels, never past FILTER_MAX_DIFF
FILTER_MAX_DIFF, FILTER_SHARE = 2, 1e-3
# ROADMAP C13's target for BM3D on the card against the CPU (its block
# distances and Wiener weights in one order on every device): no pixel
# past 1, at most BM3D_SHARE of them off by 1
BM3D_SHARE = 5e-4
# 4i's IPP row: the generic loop over the first frames of the 4c clip
GENERIC_FRAMES = 4


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls after one warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Median host-clock ms of `reps` synchronized calls after a warm-up."""
    fn()
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return sorted(ts)[reps // 2]


def issue_ms(fn, reps: int = 20) -> float:
    """Mean host-clock ms to issue one call of `fn` (no sync between
    calls): a wrapper's host time, which paces it once its kernel is
    shorter."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return t


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    require(a.shape == b.shape, f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, ops: float = 0.0) -> dict:
    """bound_ms and bound_by of a kernel that moves n_bytes (each input
    read once, each output written once) and does `ops` float32
    operations (the type of every function replaced here; the rANS
    kernels' integer operations have no peak, so their bound counts
    bytes), by the benchmark's yardstick `work.least_s`."""
    by_ops = ops / work.FP32_OPS_PER_S > n_bytes / work.HBM_BYTES_PER_S
    return {"bound_ms": work.least_s(n_bytes, ops) * 1e3,
            "bound_by": "operations" if by_ops else "bytes"}


def kernel_row(name: str, source: str, replaces: str, err, ms: float,
               plain_ms: float, bnd: dict, library_ms=None, **extra) -> dict:
    """One entry of the kernels line; `launches` is filled in from the
    main path's run."""
    return {"name": name, "route": "cuda",
            "source": f"vcf_tpu_torch/csrc/{source}",
            "replaces": f"vcf_tpu/ops/pallas/{replaces}", "launches": 0,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd,
            "library_ms": library_ms, **extra}


COUNTS = ("launches", "grid_launches", "generic_launches")


def zero_counts(kernels: dict) -> None:
    """Set every launch count of the wrappers in `kernels` to 0: `launches`,
    the grid-mode count `grid_launches` and the SAD and MC kernels'
    `generic_launches`."""
    for fn in kernels.values():
        for attr in COUNTS:
            if hasattr(fn, attr):
                setattr(fn, attr, 0)


def diff_rule(a: torch.Tensor, b: torch.Tensor, what: str):
    """(max |a - b|, share of entries that differ); raise past the +-1
    rule."""
    require(a.shape == b.shape, f"{what}: shape {tuple(a.shape)} vs "
            f"{tuple(b.shape)}")
    d = (a.to(torch.int64) - b.to(torch.int64)).abs()
    err, share = int(d.max()), float((d != 0).double().mean())
    require(err <= MAX_INDEX_DIFF and share <= MAX_DIFF_SHARE,
            f"{what} differs from its plain version: max {err}, "
            f"share {share}")
    return err, share


def phase_device() -> torch.device:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from vcf_tpu_torch.pipeline import check_full_fp32

    check_full_fp32()
    dev = torch.device("cuda", 0)
    print(f"device: {torch.cuda.get_device_name(dev)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    return dev


def phase_build() -> None:
    from vcf_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({_build.library_path().name}, nvcc {' '.join(_build.NVCC_FLAGS)})")


def clip_frames() -> tuple:
    """(base, frames): test_image(H, W, seed=3) and the FRAMES-frame clip
    of its rolled copies that phases 3, 3b, 4, 4b, 4d and 4f encode."""
    from vcf_tpu_torch.io import test_image

    base = test_image(H, W, seed=3)
    return base, np.stack([np.roll(base, (7 * i, 13 * i), (0, 1))
                           for i in range(FRAMES)])


def index_planes(codec, frames: np.ndarray) -> torch.Tensor:
    """(N, H, W, 3) u8 frames -> stored u8 index planes on the codec's
    device, as Codec.encode computes them."""
    from vcf_tpu_torch.ops import dct as dct_ops

    out = []
    for f in frames:
        x = torch.from_numpy(np.ascontiguousarray(f)).to(codec.device)
        padded = dct_ops.pad_centered(x.to(torch.float32), 8)
        k = codec._quantize(codec._analyze(padded))[0]
        out.append(torch.clamp(k + codec.spatial_offset, 0, 255)
                   .to(torch.uint8))
    return torch.stack(out)


def phase_kernels(dev, planes: torch.Tensor) -> list:
    from vcf_tpu_torch.entropy import rans
    from vcf_tpu_torch.ops.cuda import rans_decode as rd
    from vcf_tpu_torch.ops.cuda import rans_encode as re_

    g = 64
    s_streams = rans.RANSCodec._pick_streams(planes.numel(), 65536)
    lanes = rans.subband_lanes(planes, 8, s_streams)
    l = lanes.shape[1]
    fg_np, cg_np = rans.freqs_from_counts(
        rans.group_histograms(lanes, g).cpu().numpy())
    fg = torch.from_numpy(fg_np.astype(np.int64)).to(dev)
    cg = torch.from_numpy(cg_np.astype(np.int64)).to(dev)
    print(f"kernels: S={s_streams} L={l} G={g} symbols={lanes.numel()}")

    raw_k, st_k = re_.rans_encode_grouped(lanes, fg, cg)
    raw_p, st_p = re_.rans_encode_grouped_ref(lanes, fg, cg)
    torch.cuda.synchronize()
    err1 = max(max_abs_err(raw_k, raw_p), max_abs_err(st_k, st_p))
    require(err1 == 0, f"K1 differs from its plain version by {err1}")

    w_k, n_k, c_k = re_.rans_compact(raw_k)
    w_p, n_p, c_p = re_.rans_compact_ref(raw_k)
    n = int(n_k)
    require(n == int(n_p), f"K2 n_words {n} vs plain {int(n_p)}")
    err2 = max(max_abs_err(w_k[:n], w_p[:n]), max_abs_err(c_k, c_p))
    require(err2 == 0, f"K2 differs from its plain version by {err2}")
    # K2 is one pass now; what its three-kernel form returned: the
    # flagged words in order (masked_select's) and torch's row sum
    low, flags = raw_k & 0xFFFF, raw_k >= 1 << 16
    sel = torch.masked_select(low, flags)
    require(torch.equal(w_k[:n].to(torch.int32), sel.to(torch.int32))
            and torch.equal(c_k, (raw_k >> 16).sum(dim=1, dtype=torch.int32)),
            "K2 differs from its three-kernel form's outputs")

    words = w_k[:n].clone()
    out_k = rd.rans_decode_grouped(words, st_k, fg, cg, l, c_k)
    out_p = rd.rans_decode_grouped_ref(words, st_k, fg, cg, l, c_k)
    err3 = max_abs_err(out_k, out_p)
    require(err3 == 0, f"K3 differs from its plain version by {err3}")
    require(torch.equal(out_k, lanes), "K3 output differs from the lanes")
    # the one-block kernel: the path of a stream without counts
    require(torch.equal(rd.rans_decode_grouped(words, st_k, fg, cg, l), lanes),
            "K3 without counts (one block) differs from the lanes")
    print(f"kernels: bit-exact; {n} words, "
          f"{n * 16 / lanes.numel():.4f} bits/symbol")

    # K2's yardstick: one torch.masked_select of the low words under the
    # emit flags, both made before the timed call
    library_k2 = cuda_ms(lambda: torch.masked_select(low, flags), 20)
    tab = g * 256 * 4                      # the packed (G, 256) u32 table
    packed = re_.pack_tables(fg, cg, dev)
    # K1's launch alone: tables packed and the (L, S) copy made before
    sym_l = lanes.t().contiguous()
    k1_lanes, k1_tables = re_.encode_plan(s_streams, g)
    k1_extra = {
        "also_replaces": "vcf_tpu/ops/pallas/rans_encode.py:773",
        "launch_ms": cuda_ms(lambda: re_.launch_encode(
            sym_l, packed, None, g, 0), 20),
        "lanes_per_block": k1_lanes, "table_mode": k1_tables}
    print(f"time rans_encode_grouped: launch alone "
          f"{k1_extra['launch_ms']:.4f} ms ({k1_lanes}-lane blocks, tables "
          f"in {k1_tables} memory)")
    k3_extra = {
        # the look-back launch alone: tables packed before, no error read
        "launch_ms": cuda_ms(lambda: rd.launch_decode(
            words, st_k, packed, None, c_k, l, g, 0), 20),
        # the dense v0 stream has no counts: the one-block kernel
        "ms_no_counts": cuda_ms(
            lambda: rd.rans_decode_grouped(words, st_k, fg, cg, l), 3)}
    print(f"time rans_decode_grouped: look-back launch alone "
          f"{k3_extra['launch_ms']:.4f} ms; one-block kernel (no counts) "
          f"{k3_extra['ms_no_counts']:.4f} ms")
    rows = [
        ("rans_encode_grouped", "rans_encode.cu", "rans_encode.py:671", err1,
         lambda: re_.rans_encode_grouped(lanes, fg, cg),
         lambda: re_.rans_encode_grouped_ref(lanes, fg, cg), 20, 5,
         bound(nbytes(lanes, raw_k) + 4 * s_streams + tab), None),
        ("rans_compact", "rans_encode.cu", "rans_encode.py:858", err2,
         lambda: re_.rans_compact(raw_k),
         lambda: re_.rans_compact_ref(raw_k), 20, 5,
         bound(nbytes(raw_k, c_k) + 2 * n + 4), library_k2),
        ("rans_decode_grouped", "rans_decode.cu", "rans_decode.py:410", err3,
         lambda: rd.rans_decode_grouped(words, st_k, fg, cg, l, c_k),
         lambda: rd.rans_decode_grouped_ref(words, st_k, fg, cg, l, c_k),
         20, 3, bound(2 * n + 4 * s_streams + tab + 4 * l + nbytes(out_k)),
         None),
    ]
    # K1 given the transposed view of (L, S) lanes is
    # pallas_encode_grouped_raw_u8 too (timed on those lanes in phase 3e)
    extras = {"rans_encode_grouped": k1_extra,
              "rans_decode_grouped": k3_extra}
    results = []
    for name, src, rep, err, kern, plain, reps_k, reps_p, bnd, lib in rows:
        ms = cuda_ms(kern, reps_k)
        plain_ms = cuda_ms(plain, reps_p)
        print(f"time {name}: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} "
              f"ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})"
              + (f", torch.masked_select {lib:.4f} ms" if lib else ""))
        results.append(kernel_row(name, src, rep, err, ms, plain_ms, bnd, lib,
                                  diff_share=0.0, **extras.get(name, {})))
    return results


def phase_k1_ragged(dev) -> None:
    """3f: K1 in both modes (order 0, 4 and 15 classes) bit-exact against
    its plain version around its staged tile of T steps (L = 1, T - 1, T,
    T + 1, 2T + 1) at S = 1100 (not a multiple of a block's lanes, nor of
    16), and at sg = 2 with 128-lane blocks (S = 16896), whose blocks span
    65 groups and read their tables from global memory."""
    from vcf_tpu_torch.entropy import rans
    from vcf_tpu_torch.ops.cuda import rans_ctx as rc
    from vcf_tpu_torch.ops.cuda import rans_encode as re_

    t = re_.ENCODE_TILE
    shapes = [(1, 1100, n) for n in (1, t - 1, t, t + 1, 2 * t + 1)]
    shapes.append((8448, 2, t + 1))
    rng = np.random.default_rng(5)
    for g, sg, l in shapes:
        syms = torch.from_numpy(rng.integers(0, 256, size=(g * sg, l),
                                             dtype=np.uint8)).to(dev)
        # tables of at most 4 groups, repeated (min_all: every symbol
        # has a frequency)
        k = min(g, 4)
        counts = torch.stack([torch.bincount(syms[i * sg:(i + 1) * sg].reshape(
            -1).long(), minlength=256) for i in range(k)]).cpu().numpy()
        for n_ctx in (0, 4, 15):
            if n_ctx:
                c = rans.ctx_group_histograms(syms[:k * sg], k, n_ctx)
                fg, cg = rans.ctx_freqs_from_counts(c.cpu().numpy())
                enc, ref = rc.rans_encode_ctx, rc.rans_encode_ctx_ref
            else:
                fg, cg = rans.freqs_from_counts(counts)
                enc, ref = re_.rans_encode_grouped, re_.rans_encode_grouped_ref
            fgt = torch.from_numpy(np.resize(fg, (g, *fg.shape[1:])).astype(
                np.int64)).to(dev)
            cgt = torch.from_numpy(np.resize(cg, (g, *cg.shape[1:])).astype(
                np.int64)).to(dev)
            raw, st = enc(syms, fgt, cgt)
            raw_p, st_p = ref(syms, fgt, cgt)
            require(torch.equal(raw, raw_p) and torch.equal(st, st_p),
                    f"K1 ({n_ctx} classes) at S={g * sg} L={l} G={g} differs "
                    "from its plain version")
    plan = [re_.encode_plan(16896, 8448, c) for c in (0, 4, 15)]
    require(all(p == (128, "global") for p in plan),
            f"K1 at sg=2, S=16896 did not take global tables: {plan}")
    print(f"k1 ragged: both modes bit-exact at {len(shapes)} shapes x 3 "
          f"(S, L, G: {[(g * sg, l, g) for g, sg, l in shapes]}); T={t}; "
          f"sg=2 plans {plan}")


def phase_dct_kernels(dev, frames: np.ndarray) -> list:
    from vcf_tpu_torch.ops import color as color_ops
    from vcf_tpu_torch.ops.cuda import dct_kernel as dk

    x = torch.from_numpy(frames).to(dev)
    px = x.permute(0, 3, 1, 2).contiguous()
    ct = color_ops.ycocg_forward(x.to(torch.float32) - 128
                                 ).permute(0, 3, 1, 2).contiguous()
    mf = dk.static_mat(color_ops.YCOCG_FWD)
    mi = dk.static_mat(color_ops.YCOCG_INV)
    k3 = dk.fused_cdct_quantize(px, mf)
    b3 = diff_rule(k3, dk.fused_cdct_quantize_ref(px, mf), "B3")
    b4 = diff_rule(dk.fused_dequantize_cdct(k3, mi),
                   dk.fused_dequantize_cdct_ref(k3, mi), "B4")
    modes = {}
    for perc in (False, True):
        k1 = dk.fused_dct_quantize(ct, perceptual=perc)
        b1 = diff_rule(k1, dk.fused_dct_quantize_ref(ct, perceptual=perc),
                       f"B1 perceptual={perc}")
        x2 = dk.fused_dequantize_idct(k1, perceptual=perc)
        x2p = dk.fused_dequantize_idct_ref(k1, perceptual=perc)
        err2 = float((x2 - x2p).abs().max())
        require(err2 <= MAX_PLANE_ERR, f"B2 perceptual={perc} differs from "
                f"its plain version by {err2}")
        _, share2 = diff_rule(torch.round(x2), torch.round(x2p),
                              f"B2 perceptual={perc} (rounded)")
        modes[perc] = (k1, b1, (err2, share2))
        print(f"dct kernels: perceptual={perc}: B1 max {b1[0]} share "
              f"{b1[1]:.3e}; B2 max {err2:.3e}, rounded share {share2:.3e}")
    print(f"dct kernels: {FRAMES}x3x{H}x{W}: B3 max {b3[0]} share {b3[1]:.3e}; "
          f"B4 max {b4[0]} share {b4[1]:.3e}")
    torch.cuda.synchronize()

    k1p, b1p, b2p = modes[True]
    n_el = k3.numel()
    # B1/B2 perceptual: the benchmark's count, and 1 an element for the
    # perceptual multiply
    rows = [
        ("fused_dct_quantize", "153", b1p,
         lambda: dk.fused_dct_quantize(ct, perceptual=True),
         lambda: dk.fused_dct_quantize_ref(ct, perceptual=True),
         bound(nbytes(ct, k1p),
               n_el * (work.dct_ops_per_elem(8, color=False) + 1))),
        ("fused_dequantize_idct", "207", b2p,
         lambda: dk.fused_dequantize_idct(k1p, perceptual=True),
         lambda: dk.fused_dequantize_idct_ref(k1p, perceptual=True),
         bound(nbytes(k1p, ct),
               n_el * (work.dct_ops_per_elem(8, color=False) + 1))),
        ("fused_cdct_quantize", "298", b3,
         lambda: dk.fused_cdct_quantize(px, mf),
         lambda: dk.fused_cdct_quantize_ref(px, mf),
         bound(nbytes(px, k3), n_el * work.dct_ops_per_elem(8, color=True))),
        ("fused_dequantize_cdct", "334", b4,
         lambda: dk.fused_dequantize_cdct(k3, mi),
         lambda: dk.fused_dequantize_cdct_ref(k3, mi),
         bound(nbytes(k3, px), n_el * work.dct_ops_per_elem(8, color=True))),
    ]
    results = []
    for name, line, (err, share), kern, plain, bnd in rows:
        ms, plain_ms = cuda_ms(kern, 20), cuda_ms(plain, 5)
        print(f"time {name}: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} "
              f"ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), "
              f"{ms / bnd['bound_ms']:.2f}x the bound")
        results.append(kernel_row(name, "dct.cu", f"dct_kernel.py:{line}",
                                  err, ms, plain_ms, bnd, diff_share=share))
    # B1/B2 in plain mode too (BatchCodec's color="none" route)
    k1, _, _ = modes[False]
    print_plain_mode(dk, ct, k1, grid_layout=False)
    return results


def print_plain_mode(dk, ct: torch.Tensor, k1: torch.Tensor,
                     grid_layout: bool) -> None:
    """Time B1 and B2 in plain mode (no perceptual table) on the clip's
    planes ct and B1's indexes k1, B1 also against its plain version."""
    kw = dict(grid_layout=grid_layout)
    bnd = bound(nbytes(ct, k1),
                k1.numel() * work.dct_ops_per_elem(8, color=False))
    ms1 = cuda_ms(lambda: dk.fused_dct_quantize(ct, **kw), 20)
    plain1 = cuda_ms(lambda: dk.fused_dct_quantize_ref(ct, **kw), 5)
    ms2 = cuda_ms(lambda: dk.fused_dequantize_idct(k1, **kw), 20)
    print(f"time plain mode{' [grid_layout]' if grid_layout else ''}: "
          f"fused_dct_quantize {ms1:.4f} ms ({ms1 / bnd['bound_ms']:.2f}x "
          f"the bound, {bnd['bound_ms']:.4f} ms), plain torch {plain1:.4f} "
          f"ms; fused_dequantize_idct {ms2:.4f} ms "
          f"({ms2 / bnd['bound_ms']:.2f}x)")


def phase_main_path(dev, frames: np.ndarray, planes: torch.Tensor) -> dict:
    from vcf_tpu_torch import Codec, CodecConfig, CodeStream, metrics
    from vcf_tpu_torch.entropy.rans import GroupedRANSCodec
    from vcf_tpu_torch.ops.cuda import rans_decode as rd
    from vcf_tpu_torch.ops.cuda import rans_encode as re_

    kernels = {"rans_encode_grouped": re_.rans_encode_grouped,
               "rans_compact": re_.rans_compact,
               "rans_decode_grouped": rd.rans_decode_grouped}
    cfg = CodecConfig(entropy="grans")
    frame = frames[0]
    codec = Codec(cfg, device=dev)
    k_enc = index_planes(codec, frame[None])[0].cpu().numpy()
    for fn in kernels.values():
        fn.launches = 0

    t0 = time.perf_counter()
    cs = codec.encode(frame)
    blob = cs.to_bytes()
    cs2 = CodeStream.from_bytes(blob)
    k_dec, _ = codec._load_indexes(cs2, offset=codec.spatial_offset,
                                   signed=True)
    rec = codec.decode(cs2)
    t_frame = time.perf_counter() - t0
    gcodec = GroupedRANSCodec(device=dev)
    planes_np = planes.cpu().numpy()
    payload, side = gcodec.encode(planes_np)
    batch_back = gcodec.decode(payload, side)
    launches = {name: fn.launches for name, fn in kernels.items()}

    require(cs2["grans_model"][0] == 2, "the frame did not take grouped lanes")
    require(np.array_equal(k_dec + codec.spatial_offset, k_enc.astype(np.int32)),
            "decoded index planes differ from the encoded ones")
    require(np.array_equal(batch_back, planes_np),
            "batch index planes did not round-trip")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the main path")

    cpu = Codec(cfg, device="cpu")
    k_cpu = index_planes(cpu, frame[None])[0].numpy()
    diff = np.abs(k_cpu.astype(np.int32) - k_enc.astype(np.int32))
    n_diff = int(np.count_nonzero(diff))
    require(int(diff.max()) <= MAX_INDEX_DIFF
            and n_diff <= MAX_DIFF_SHARE * diff.size,
            f"GPU vs CPU indexes: {n_diff} differ, max {int(diff.max())}")
    cs_cpu = cpu.encode(frame)
    if n_diff == 0:
        require(cs_cpu.to_bytes() == blob,
                "identical indexes but GPU and CPU streams differ")
    rec_cpu = cpu.decode(cs_cpu)
    rmse, rmse_cpu = metrics.rmse(frame, rec), metrics.rmse(frame, rec_cpu)
    require(abs(rmse - rmse_cpu) < 1e-3, f"rmse {rmse} vs CPU {rmse_cpu}")
    bpp = metrics.bpp(cs, frame.shape)
    batch_bpp = (len(payload) + len(side["grans_model"])) * 8.0 / (
        planes_np.shape[0] * planes_np.shape[1] * planes_np.shape[2])
    print(f"main path: 1088x1920 grans frame rmse {rmse:.4f} bpp {bpp:.4f} "
          f"(CPU run rmse {rmse_cpu:.4f}, {n_diff} of {diff.size} indexes "
          f"differ), encode+container+decode {t_frame * 1e3:.1f} ms; "
          f"8-frame batch {batch_bpp:.4f} bpp round-trips; launches {launches}")
    timings = warm_timings(codec, gcodec, frame, planes_np)
    print(f"warm timings (ms, host clock, synchronized): {json.dumps(timings)}")
    return launches


def warm_timings(codec, gcodec, frame, planes_np) -> dict:
    """Second-run stage times of the frame codec and the batch codec."""
    def ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    out = {}
    enc_ms, cs = ms(lambda: codec.encode(frame))
    out.update({f"frame encode {k}": v * 1e3
                for k, v in codec.last_timings.as_dict().items()})
    dec_ms, _ = ms(lambda: codec.decode(cs))
    out.update({f"frame decode {k}": v * 1e3
                for k, v in codec.last_timings.as_dict().items()})
    out["frame encode"], out["frame decode"] = enc_ms, dec_ms
    out["batch encode"], (payload, side) = ms(lambda: gcodec.encode(planes_np))
    out["batch decode"], _ = ms(lambda: gcodec.decode(payload, side))
    return out


def run_clip(dev, frames: np.ndarray, ccfg, kernels: dict) -> tuple:
    """IIICodec encode -> bytes -> decode with every count set to 0
    first, and the round-trip check of the clip's index planes; returns
    (codec, launches, stream, decoded frames, planes, seconds)."""
    from vcf_tpu_torch import CodeStream
    from vcf_tpu_torch.config import VideoConfig
    from vcf_tpu_torch.video import IIICodec

    iii = IIICodec(VideoConfig(n_frames=len(frames)), ccfg, dev)
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    cs = iii.encode(frames)
    cs2 = CodeStream.from_bytes(cs.to_bytes())
    rec = iii.decode(cs2)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    require(cs2.get_json("payload")["batched"], "the clip was not batched")
    side = {name[len("clip."):]: cs2[name] for name in cs2
            if name.startswith("clip.") and name != "clip.payload"}
    back = iii.still.entropy_codec.decode(cs2["clip.payload"], side)
    planes = iii._batch.encode_planes(frames)
    require(np.array_equal(back, planes),
            "clip index planes did not round-trip")
    return iii, launches, cs, rec, planes, seconds


def clip_report(iii, frames, cs, rec, planes, seconds, what) -> dict:
    """rmse against the port's CPU BatchCodec, bpp, warm times."""
    from vcf_tpu_torch import metrics
    from vcf_tpu_torch.parallel import BatchCodec

    cpu = BatchCodec(iii.ccfg, "cpu")
    planes_cpu = cpu.encode_planes(frames)
    rec_cpu = cpu.decode_planes(planes_cpu)
    n_diff = int(np.count_nonzero(planes_cpu != planes))
    rmse, rmse_cpu = metrics.rmse(frames, rec), metrics.rmse(frames, rec_cpu)
    require(abs(rmse - rmse_cpu) < 1e-3,
            f"{what}: rmse {rmse} vs CPU BatchCodec {rmse_cpu}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cs_w = iii.encode(frames)
    enc_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    iii.decode(cs_w)
    torch.cuda.synchronize()
    dec_ms = (time.perf_counter() - t0) * 1e3
    report = {"rmse": rmse, "rmse_cpu": rmse_cpu,
              "bpp": metrics.bpp(cs, frames.shape),
              "indexes_differing_from_cpu": n_diff,
              "first_run_s": seconds, "warm_encode_ms": enc_ms,
              "warm_decode_ms": dec_ms}
    print(f"{what}: {json.dumps(report)}")
    return report


def phase_clip(dev, frames: np.ndarray, planes_codec: torch.Tensor) -> dict:
    from vcf_tpu_torch import CodecConfig
    from vcf_tpu_torch.ops.cuda import dct_kernel as dk
    from vcf_tpu_torch.ops.cuda import rans_decode as rd
    from vcf_tpu_torch.ops.cuda import rans_encode as re_

    kernels = {"rans_encode_grouped": re_.rans_encode_grouped,
               "rans_compact": re_.rans_compact,
               "rans_decode_grouped": rd.rans_decode_grouped,
               "fused_dct_quantize": dk.fused_dct_quantize,
               "fused_dequantize_idct": dk.fused_dequantize_idct,
               "fused_cdct_quantize": dk.fused_cdct_quantize,
               "fused_dequantize_cdct": dk.fused_dequantize_cdct}
    iii, launches, cs, rec, planes, seconds = run_clip(
        dev, frames, CodecConfig(entropy="grans"), kernels)
    print(f"clip path: launches {launches}")
    for name in ("rans_encode_grouped", "rans_compact", "rans_decode_grouped",
                 "fused_cdct_quantize", "fused_dequantize_cdct"):
        require(launches[name] > 0,
                f"kernel {name} was not launched on the clip path")
    err, share = diff_rule(torch.from_numpy(planes), planes_codec.cpu(),
                           "BatchCodec planes vs per-frame Codec")
    print(f"clip path: BatchCodec vs per-frame Codec indexes: max {err}, "
          f"share {share:.3e}")
    grans = clip_report(iii, frames, cs, rec, planes, seconds,
                        f"clip {FRAMES}x{H}x{W} grans")

    n = PERCEPTUAL_FRAMES
    iii_p, launches_p, cs_p, rec_p, planes_p, seconds_p = run_clip(
        dev, frames[:n], CodecConfig(entropy="grans", perceptual=True),
        kernels)
    print(f"perceptual clip path: launches {launches_p}")
    for name in ("rans_encode_grouped", "rans_compact", "rans_decode_grouped",
                 "fused_dct_quantize", "fused_dequantize_idct"):
        require(launches_p[name] > 0, f"kernel {name} was not launched on "
                "the perceptual clip path")
    clip_report(iii_p, frames[:n], cs_p, rec_p, planes_p, seconds_p,
                f"clip {n}x{H}x{W} grans perceptual")
    return {"fused_cdct_quantize": launches["fused_cdct_quantize"],
            "fused_dequantize_cdct": launches["fused_dequantize_cdct"],
            "fused_dct_quantize": launches_p["fused_dct_quantize"],
            "fused_dequantize_idct": launches_p["fused_dequantize_idct"]}, \
        (rec, planes, grans["bpp"], cs.to_bytes()), rec_p


def phase_motion_kernels(dev, clip: np.ndarray) -> list:
    from vcf_tpu_torch.ops import motion
    from vcf_tpu_torch.ops.cuda import _build
    from vcf_tpu_torch.ops.cuda import mc_kernel as mk
    from vcf_tpu_torch.ops.cuda import sad_kernel as sk

    x = torch.from_numpy(clip).to(dev)
    luma = motion.to_luma(x)
    ref_l, cur_l = luma[:-1].contiguous(), luma[1:].contiguous()
    # the 7 frame pairs, and 2 of them: the IPP loops' launch shape (a
    # GOP batch of 2)
    ref2, cur2 = ref_l[:2].contiguous(), cur_l[:2].contiguous()
    # the other side of the screen's choice: 2 frames whose top half is a
    # flat sky brightening 2 levels a frame (every displacement ties there:
    # long lists, summed a thread an item)
    half = clip[:3].copy()
    for i in range(3):
        half[i, :H // 2] = (110 + 2 * i, 150 + 2 * i, 200 + 2 * i)
    half_l = motion.to_luma(torch.from_numpy(half).to(dev))
    zero_counts({"sad_search": sk.sad_search})
    refined = {}
    sad_err = 0.0
    for what, r, c in (("7 frames", ref_l, cur_l), ("2 frames", ref2, cur2),
                       ("2 frames half flat", half_l[:2].contiguous(),
                        half_l[1:].contiguous())):
        mv_k, sad_k, n_ref, n_thread = sk.count_refined(r, c, ME_BLOCK,
                                                        SEARCH)
        refined[what] = {"displacements": n_ref, "thread_ctas": n_thread}
        mv_p, sad_p = sk.sad_search_ref(r, c, ME_BLOCK, SEARCH)
        torch.cuda.synchronize()
        n_mv = int((mv_k != mv_p).any(-1).sum())
        err = float((sad_k - sad_p).abs().max())
        require(n_mv == 0 and err == 0,
                f"sad_search differs from its plain version at {what}: "
                f"{n_mv} mvs, SAD max {err}")
        if what == "7 frames":
            moving = float((mv_k != 0).any(-1).double().mean())
            real_mv = mv_k
        sad_err = max(sad_err, err)
    require(refined["7 frames"]["displacements"] > 0 and
            refined["7 frames"]["thread_ctas"] == 0 and
            refined["2 frames half flat"]["thread_ctas"] > 0,
            f"sad_search: the refinement's two modes were not both taken "
            f"({json.dumps(refined)})")
    require(sk.sad_search.launches == 3 and
            sk.sad_search.generic_launches == 0,
            "sad_search: phase 3c's launches did not all take the "
            "block-size instance")
    # a range past the instance's shared memory (m = 16 from s = 77) takes
    # the generic kernel's global mode: ROADMAP C12, on a 64 x 96 crop
    far = 77
    r_far = ref2[:, :64, :96].contiguous()
    c_far = cur2[:, :64, :96].contiguous()
    mv_k, sad_k = sk.sad_search(r_far, c_far, ME_BLOCK, far)
    mv_p, sad_p = sk.sad_search_ref(r_far, c_far, ME_BLOCK, far)
    require(torch.equal(mv_k, mv_p) and torch.equal(sad_k, sad_p) and
            sk.sad_search.generic_launches == 1,
            f"sad_search's global mode (m={ME_BLOCK}, s={far}) differs from "
            "its plain version or did not launch")
    print(f"sad_search global mode: m={ME_BLOCK} s={far} on 2x64x96 equals "
          f"its plain version; kernel "
          f"{cuda_ms(lambda: sk.sad_search(r_far, c_far, ME_BLOCK, far), 5):.4f}"
          " ms")
    mode = f"sad_search_kernel<{ME_BLOCK}, R> (block-size instance)"
    n_disp = (2 * SEARCH + 1) ** 2
    per_frame = n_disp * (H // ME_BLOCK) * (W // ME_BLOCK)
    print(f"sad_search screen: {json.dumps(refined)} displacements summed "
          f"again in float64 and CTAs that summed them a thread an item, "
          f"of {ref_l.shape[0] * per_frame} / {2 * per_frame} / "
          f"{2 * per_frame} displacements")

    g, h, w = cur_l.shape
    frames = x[:-1].permute(0, 3, 1, 2).to(torch.float32).contiguous()
    rng = np.random.default_rng(5)
    mv = rng.integers(-SEARCH, SEARCH + 1,
                      (g, h // ME_BLOCK, w // ME_BLOCK, 2)).astype(np.int32)
    mv[:, 0, :, 0], mv[:, -1, :, 0] = -SEARCH, SEARCH   # out of the frame
    mv[:, :, 0, 1], mv[:, :, -1, 1] = -SEARCH, SEARCH
    mv_t = torch.from_numpy(mv).to(dev)
    frames_cl = frames.permute(0, 2, 3, 1).contiguous()
    mc = {"mc_apply_planar": mk.mc_apply_planar, "mc_apply": mk.mc_apply}
    zero_counts(mc)
    out_k = mk.mc_apply_planar(frames, mv_t, ME_BLOCK)
    mc_err = float((out_k - mk.mc_apply_planar_ref(frames, mv_t, ME_BLOCK)
                    ).abs().max())
    out_cl = mk.mc_apply(frames_cl, mv_t, ME_BLOCK)
    cl_err = float((out_cl - mk.mc_apply_ref(frames_cl, mv_t, ME_BLOCK)
                    ).abs().max())
    torch.cuda.synchronize()
    require(mc_err == 0 and cl_err == 0,
            f"MC kernel differs from its plain version: planar {mc_err}, "
            f"channel-last {cl_err}")
    require(torch.equal(out_cl, out_k.permute(0, 2, 3, 1)),
            "the two MC layouts disagree")
    # the clip's real SAD mvs (its background pans, so nearly every block
    # shares one vector) and the IPP loops' 2 frames
    for mvs in (mv_t, real_mv):
        for n in (g, 2):
            for fn, plain, fr in ((mk.mc_apply_planar, mk.mc_apply_planar_ref,
                                   frames), (mk.mc_apply, mk.mc_apply_ref,
                                             frames_cl)):
                fr_n, mv_n = fr[:n], mvs[:n]
                require(torch.equal(fn(fr_n, mv_n, ME_BLOCK),
                                    plain(fr_n, mv_n, ME_BLOCK)),
                        f"{fn.__name__} differs from its plain version on "
                        f"{n} frames")
    lib = _build.load()
    require(all(mk.launch_mode(ME_BLOCK, fr.data_ptr(), o.data_ptr()) ==
                "vector" and lib.vcf_mc_mode(fr.data_ptr(), o.data_ptr(), 3,
                                             w, ME_BLOCK) == 0
                for fr, o in ((frames, out_k), (frames_cl, out_cl))) and
            all(fn.launches == 5 and fn.generic_launches == 0
                for fn in mc.values()),
            f"MC: phase 3c's launches did not all take the vector mode "
            f"({[(fn.launches, fn.generic_launches) for fn in mc.values()]})")
    # one PyTorch call for the same gather: torch.take with the source
    # index of every output (int64, 8 bytes an element), built beforehand
    idx = mc_source_index(frames.shape, mv_t, ME_BLOCK)
    require(torch.equal(torch.take(frames, idx), out_k),
            "torch.take with the MC source index differs from the kernel")
    print(f"motion kernels: {g}x{h}x{w}, m={ME_BLOCK} s={SEARCH}: SAD mvs "
          f"and SADs equal ({moving:.3f} of blocks move); MC planar and "
          "channel-last bit-exact on random and real mvs at 7 and 2 frames, "
          "vector mode")

    # SAD: |cur - ref| and the sum, 3 operations per term, float32 in the
    # function replaced (the kernel's float32 screen and float64 second
    # sums are its own choice, C6): a floor that CUDA-core adds, which
    # the 67 TFLOP/s rate counts as half an FMA, cannot reach
    n_blocks = ref_l.shape[0] * (h // ME_BLOCK) * (w // ME_BLOCK)
    sad_ops = 3 * n_blocks * n_disp * ME_BLOCK ** 2
    rows = [
        ("sad_search", "sad_kernel.py:58", "sad_kernel.py:141", sad_err,
         lambda: sk.sad_search(ref_l, cur_l, ME_BLOCK, SEARCH),
         lambda: sk.sad_search_ref(ref_l, cur_l, ME_BLOCK, SEARCH),
         bound(nbytes(ref_l, cur_l) + n_blocks * 12, sad_ops)),
        ("mc_apply_planar", "mc_kernel.py:115", "mc_kernel.py:103", mc_err,
         lambda: mk.mc_apply_planar(frames, mv_t, ME_BLOCK),
         lambda: mk.mc_apply_planar_ref(frames, mv_t, ME_BLOCK),
         bound(nbytes(frames, mv_t, out_k))),
    ]
    results = []
    for name, rep, also, err, kern, plain, bnd in rows:
        ms, plain_ms = cuda_ms(kern, 20), cuda_ms(plain, 3)
        print(f"time {name}: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} "
              f"ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        results.append(kernel_row(name, "motion.cu", rep, err, ms, plain_ms,
                                  bnd, also_replaces=f"vcf_tpu/ops/pallas/{also}",
                                  diff_share=0.0))
    sad_row, mc_row = results
    sad_row["ms_2_frames"] = cuda_ms(
        lambda: sk.sad_search(ref2, cur2, ME_BLOCK, SEARCH), 20)
    sad_row["mode"] = mode
    sad_row["refined"] = refined
    print(f"time sad_search at 2 frames: {sad_row['ms_2_frames']:.4f} ms "
          f"({sad_row['mode']})")
    fr2, mv2 = frames[:2], mv_t[:2]
    mc_row.update({
        "ms_2_frames": cuda_ms(lambda: mk.mc_apply_planar(fr2, mv2, ME_BLOCK),
                               20),
        "bound_ms_2_frames": bound(nbytes(fr2, mv2, fr2))["bound_ms"],
        "channel_last_ms": cuda_ms(
            lambda: mk.mc_apply(frames_cl, mv_t, ME_BLOCK), 20),
        "channel_last_plain_ms": cuda_ms(
            lambda: mk.mc_apply_ref(frames_cl, mv_t, ME_BLOCK), 3),
        "mode": "vector",
        "wrapper_host_ms_2_frames": issue_ms(
            lambda: mk.mc_apply_planar(fr2, mv2, ME_BLOCK)),
        "library_ms": cuda_ms(lambda: torch.take(frames, idx), 20),
        "library": "torch.take(ref, idx), idx an int64 source index built "
                   "beforehand: 8 more bytes read an element"})
    print(f"time mc_apply_planar: 2 frames {mc_row['ms_2_frames']:.4f} ms "
          f"(bound {mc_row['bound_ms_2_frames']:.4f}; wrapper's host "
          f"{mc_row['wrapper_host_ms_2_frames']:.4f} ms a call), "
          f"channel-last {mc_row['channel_last_ms']:.4f} ms (plain torch "
          f"{mc_row['channel_last_plain_ms']:.4f}), torch.take "
          f"{mc_row['library_ms']:.4f} ms")
    return results + [luma_row(x)]


def luma_row(x: torch.Tensor) -> dict:
    """The luma kernel at the planar IPP loop's two launch shapes (a GOP
    batch of 8): the (8, 3, H, W) float32 reference with the round, on
    half-integer pixels here, and a u8 frame of an (8, T, H, W, 3) clip,
    a channels-last view; each bit for bit against its plain version,
    in its vector mode, and timed."""
    from vcf_tpu_torch.ops.cuda import luma_kernel as lk

    planar = x.permute(0, 3, 1, 2).to(torch.float32).contiguous()
    ref = planar + 0.5 * (planar % 2)            # ties of the round
    view = torch.stack([x.roll(1, 0), x], 1)[:, 1]
    calls = {"f32 planar, round": (ref, -3, True),
             "u8 channels-last view": (view, -1, False)}
    zero_counts({"luma": lk.luma})
    out = {}
    for what, (inp, axis, rnd) in calls.items():
        got = lk.luma(inp, axis, round=rnd)
        want = lk.luma_ref(inp, axis, round=rnd)
        torch.cuda.synchronize()
        n_diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        require(n_diff == 0, f"luma kernel differs from its plain version "
                f"on the {what} input: {n_diff} lumas")
        xs, strides = lk.frames_of(inp, axis)
        out[what] = {
            "mode": lk.launch_mode(xs.data_ptr(), inp.dtype, xs.shape[:3],
                                   strides),
            "ms": cuda_ms(lambda: lk.luma(inp, axis, round=rnd), 20),
            "plain_ms": cuda_ms(lambda: lk.luma_ref(inp, axis, round=rnd), 3),
            **bound(nbytes(inp, got))}
    require(lk.luma.generic_launches == 0 and
            [o["mode"] for o in out.values()] == ["planar", "channels_last"],
            f"luma: phase 3c's launches did not take the vector modes "
            f"({json.dumps(out)})")
    for what, o in out.items():
        print(f"time luma {what} {tuple(calls[what][0].shape)}: kernel "
              f"{o['ms']:.4f} ms, plain torch {o['plain_ms']:.4f} ms, bound "
              f"{o['bound_ms']:.4f} ms ({o['bound_by']}), "
              f"{o['ms'] / o['bound_ms']:.2f}x the bound")
    f32, u8 = out.values()
    row = kernel_row("luma", "motion.cu", "", 0, f32["ms"], f32["plain_ms"],
                     {"bound_ms": f32["bound_ms"],
                      "bound_by": f32["bound_by"]},
                     diff_share=0.0, mode="planar / channels_last",
                     u8_view_ms=u8["ms"], u8_view_plain_ms=u8["plain_ms"],
                     u8_view_bound_ms=u8["bound_ms"])
    row["replaces"] = ("none: vcf_tpu/video/ipp.py:409-410 takes the planar "
                       "loop's lumas as an XLA dot")
    return row


def dwt_row() -> dict:
    """3g: the DWT level kernels at the dwt_wire_8f cell's level shapes,
    db5, (8, H, W, 3) float32; each level against the plain chain and
    timed; the row sums the five levels of each direction."""
    from vcf_tpu_torch.ops import dwt

    bank = dwt.get_bank("db5")
    gen = torch.Generator(device="cuda").manual_seed(11)
    cur = torch.rand((FRAMES, H, W, 3), device="cuda", generator=gen) * 255 \
        - 128
    levels = []
    for lvl in range(1, 6):
        got = dwt.analyze_level(cur, bank, 1)
        want = dwt.analyze_level_ref(cur, bank, 1)
        n_diff = sum(int((g.view(torch.int32) != w.view(torch.int32)).sum())
                     for g, w in zip((got[0],) + got[1], (want[0],) + want[1]))
        hw = tuple(cur.shape[1:3])
        y = dwt.synthesize_level(got[0], got[1], bank, hw, 1)
        y_ref = dwt.synthesize_level_ref(got[0], got[1], bank, hw, 1)
        n_diff += int((y != y_ref).sum())
        require(n_diff == 0, f"DWT level {lvl}: {n_diff} values differ from "
                "the plain chain")
        args = (got[0], got[1], bank, hw, 1)
        levels.append({
            "level": lvl, "input": list(cur.shape),
            "ms": cuda_ms(lambda: dwt.analyze_level(cur, bank, 1), 20),
            "plain_ms": cuda_ms(lambda: dwt.analyze_level_ref(cur, bank, 1),
                                3),
            "synthesis_ms": cuda_ms(lambda: dwt.synthesize_level(*args), 20),
            "synthesis_plain_ms": cuda_ms(
                lambda: dwt.synthesize_level_ref(*args), 3),
            **bound(2 * nbytes(cur))})
        print(f"time dwt level {lvl} {tuple(cur.shape)}: analysis "
              f"{levels[-1]['ms']:.4f} ms (plain {levels[-1]['plain_ms']:.4f})"
              f", synthesis {levels[-1]['synthesis_ms']:.4f} ms (plain "
              f"{levels[-1]['synthesis_plain_ms']:.4f}), bound "
              f"{levels[-1]['bound_ms']:.4f} ms each")
        cur = got[0]
    total = {k: sum(lv[k] for lv in levels)
             for k in ("ms", "plain_ms", "synthesis_ms", "synthesis_plain_ms",
                       "bound_ms")}
    print(f"time dwt 5 levels: analysis {total['ms']:.4f} ms, synthesis "
          f"{total['synthesis_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms "
          f"each ({total['ms'] / total['bound_ms']:.2f}x / "
          f"{total['synthesis_ms'] / total['bound_ms']:.2f}x)")
    row = kernel_row("dwt_level", "dwt.cu", "", 0, total["ms"],
                     total["plain_ms"], {"bound_ms": total["bound_ms"],
                                         "bound_by": "bytes"},
                     diff_share=0.0, synthesis_ms=total["synthesis_ms"],
                     synthesis_plain_ms=total["synthesis_plain_ms"],
                     levels=levels)
    row["replaces"] = ("none: vcf_tpu/ops/dwt.py _down_axis / _up_axis are "
                       "XLA ops")
    return row


def dwt_ends_rows(frames: np.ndarray) -> list:
    """3g: the DWT clip path's two ends (csrc/dwt_ends.cu) at the
    dwt_wire_8f cell's shapes, db5, 8 x 1088 x 1920 x 3: colour in, the
    quantizer into the lane grid, the dequantizer from K3's transposed view
    of the grid, colour out; each bit for bit against its plain torch
    chain on the card and timed beside it, the bound the bytes each reads
    and writes once (the dequantizer reads the grid's real symbols
    alone).  Launches are filled in from 4e."""
    from vcf_tpu_torch import Codec, CodecConfig
    from vcf_tpu_torch.entropy import dwt_device as dd
    from vcf_tpu_torch.ops import dct as dct_ops
    from vcf_tpu_torch.ops import dwt
    from vcf_tpu_torch.ops.cuda import dwt_ends as dwe

    codec = Codec(CodecConfig(spatial="dwt", entropy="cgrans"), device="cuda")
    d, qss, off = codec._dwt, codec.config.qss, codec.spatial_offset
    fwd, inv = d._matrix(codec, False), d._matrix(codec, True)
    x = torch.from_numpy(frames).cuda()
    n, shape = x.shape[0], tuple(x.shape[1:])
    sizes = d._grid_sizes(shape)
    sg, l = dd.grid_dims(sizes)
    shapes = [(n,) + s for s in d._band_shapes(shape)]
    mult = 1 << d.levels

    def color_in_ref():
        padded = dct_ops.pad_centered(x.to(torch.float32), mult, 1)
        return d._color(codec, padded - off, False)

    ct = dwe.color_in(x, fwd, off, mult)
    bands = d.flatten(dwt.analyze(ct, d.wavelet, d.levels, 1))
    lanes = dwe.bands_to_lanes(bands, qss, sg, l)
    k3_view = lanes.t().contiguous().t()        # K3's (S, L) view
    flat = dwe.lanes_to_bands(k3_view, qss, shapes)
    y = dwt.synthesize(d.unflatten(flat), d.wavelet, 1)
    out = dwe.color_out(y, inv, off, shape[:2])

    def color_out_ref():
        z = dct_ops.unpad_centered(d._color(codec, y, True) + off, shape, 1)
        return torch.clamp(torch.round(z), 0, 255).to(torch.uint8)

    real = n * sum(sizes)                       # symbols the grid holds
    runs = {
        "dwt_color_in": (lambda: dwe.color_in(x, fwd, off, mult),
                         color_in_ref, ct, nbytes(x, ct)),
        "dwt_quantize_grid": (
            lambda: dwe.bands_to_lanes(bands, qss, sg, l),
            lambda: dd.bands_to_grid(d._byte_planes(codec, bands), sg, l,
                                     frames=n),
            lanes, nbytes(*bands, lanes)),
        "dwt_dequantize_grid": (
            lambda: dwe.lanes_to_bands(k3_view, qss, shapes),
            lambda: d._grid_flat(codec, dd.grid_to_bands(
                k3_view, sizes, sg, frames=n), shapes),
            flat, real + nbytes(*flat)),
        # the float32 pixels it keeps, read once, and the u8 frames
        "dwt_color_out": (lambda: dwe.color_out(y, inv, off, shape[:2]),
                          color_out_ref, out, 5 * out.numel())}
    rows = []
    for name, (kernel, plain, got, n_bytes) in runs.items():
        want = plain()
        torch.cuda.synchronize()
        pairs = zip(got, want) if isinstance(got, list) else [(got, want)]
        n_diff = sum(int((a.view(torch.uint8) != b.view(torch.uint8)).sum())
                     for a, b in pairs)
        require(n_diff == 0, f"{name}: {n_diff} bytes differ from the plain "
                "chain")
        ms, plain_ms = cuda_ms(kernel, 20), cuda_ms(plain, 3)
        bnd = bound(n_bytes)
        print(f"time {name} {tuple(x.shape)}: kernel {ms:.4f} ms, plain "
              f"torch {plain_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']}), {ms / bnd['bound_ms']:.2f}x the bound")
        row = kernel_row(name, "dwt_ends.cu", "", 0, ms, plain_ms, bnd,
                         diff_share=0.0)
        row["replaces"] = ("none: vcf_tpu/ops/dwt.py's colour, quantizer and "
                           "byte planes are XLA ops")
        rows.append(row)
    return rows


def mc_source_index(shape, mv: torch.Tensor, m: int) -> torch.Tensor:
    """The int64 flat index into (G, C, H, W) frames of every motion-
    compensated output's source (the clamped, displaced pixel)."""
    g, c, h, w = shape
    dev = mv.device
    vy, vx = (mv[..., k].repeat_interleave(m, 1).repeat_interleave(m, 2)
              .to(torch.int64) for k in (0, 1))       # (G, H, W)
    sy = (torch.arange(h, device=dev)[:, None] + vy).clamp(0, h - 1)
    sx = (torch.arange(w, device=dev) + vx).clamp(0, w - 1)
    plane = torch.arange(g * c, device=dev).view(g, c, 1, 1)
    return (plane * h + sy[:, None]) * w + sx[:, None]


def require_ipp_modes(what: str) -> None:
    """The IPP paths' SAD launches took the block-size instance and their
    MC launches the vector mode."""
    from vcf_tpu_torch.ops.cuda import mc_kernel as mk
    from vcf_tpu_torch.ops.cuda import sad_kernel as sk

    for name, fn in (("SAD kernel", sk.sad_search),
                     ("MC kernel", mk.mc_apply_planar)):
        require(fn.launches > 0 and fn.generic_launches == 0,
                f"{what}: the {name}'s generic mode launched "
                f"({fn.generic_launches} of {fn.launches})")


def ipp_split(ipp, clip: np.ndarray) -> dict:
    """Warm stage times of the IPP codec, host clock around synchronized
    calls: the whole encode and decode, then each split into its device
    GOP loop (with the planes' copy to the host) and its entropy stage."""
    def ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    out = {}
    out["encode"], cs = ms(lambda: ipp.encode(clip))
    out["decode"], _ = ms(lambda: ipp.decode(cs))
    n, h, w, _ = clip.shape
    gops = torch.from_numpy(clip).to(ipp.device).reshape(-1, GOP, h, w, 3)
    out["encode: GOP loop"], enc = ms(lambda: ipp._gop_encode(gops))
    out["encode: planes to host"], planes = ms(
        lambda: ipp._store(enc[0]).reshape(n, h, w, 3).cpu().numpy())
    out["encode: entropy"], (payload, side) = ms(
        lambda: ipp.entropy_codec.encode(planes))
    out["decode: entropy"], back = ms(
        lambda: ipp.entropy_codec.decode(payload, side))
    planes_t = ipp._load(torch.from_numpy(back).to(ipp.device).reshape(
        -1, GOP, h, w, 3))
    out["decode: GOP loop"], _ = ms(
        lambda: ipp._gop_decode(planes_t, enc[1]))
    return out


def phase_ipp(dev, clip: np.ndarray) -> tuple:
    from vcf_tpu_torch import CodecConfig, CodeStream, metrics, video
    from vcf_tpu_torch.config import VideoConfig
    from vcf_tpu_torch.ops.cuda import dct_kernel as dk
    from vcf_tpu_torch.ops.cuda import mc_kernel as mk
    from vcf_tpu_torch.ops.cuda import rans_decode as rd
    from vcf_tpu_torch.ops.cuda import rans_encode as re_
    from vcf_tpu_torch.ops.cuda import sad_kernel as sk

    kernels = {"sad_search": sk.sad_search,
               "mc_apply_planar": mk.mc_apply_planar,
               "fused_dct_quantize": dk.fused_dct_quantize,
               "fused_dequantize_idct": dk.fused_dequantize_idct,
               "rans_encode_grouped": re_.rans_encode_grouped,
               "rans_compact": re_.rans_compact,
               "rans_decode_grouped": rd.rans_decode_grouped}
    n = len(clip)
    vcfg = VideoConfig(mode="ipp", n_frames=n, gop_size=GOP,
                       me_block=ME_BLOCK, search_range=SEARCH)
    ccfg = CodecConfig(entropy="grans", subbands=False)
    ipp = video.get(vcfg, ccfg, dev)
    zero_counts(kernels)
    t0 = time.perf_counter()
    cs = ipp.encode(clip)
    blob = cs.to_bytes()
    cs2 = CodeStream.from_bytes(blob)
    rec = ipp.decode(cs2)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    print(f"ipp path: launches {launches}")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} was not launched on the IPP path")
    require_ipp_modes("IPP path")

    side = {name[len("clip."):]: cs2[name] for name in cs2
            if name.startswith("clip.") and name != "clip.payload"}
    back = ipp.entropy_codec.decode(cs2["clip.payload"], side)
    require(np.array_equal(back, ipp.last_planes),
            "IPP index planes did not round-trip")
    require(np.array_equal(rec.astype(np.float32),
                           ipp.last_recon.cpu().numpy()),
            "the decoder differs from the encoder's closed-loop reconstruction")

    cpu = video.get(vcfg, ccfg, "cpu")
    t0 = time.perf_counter()
    cs_cpu = cpu.encode(clip)
    cpu_s = time.perf_counter() - t0
    rec_cpu = cpu.last_recon.to(torch.uint8).numpy()
    mv_names = [name for name in cs if name.startswith("mv_")]
    mv_diff = sum(int((cs.get_array(k) != cs_cpu.get_array(k)).any(-1).sum())
                  for k in mv_names)
    mv_total = sum(cs.get_array(k).shape[0] * cs.get_array(k).shape[1]
                   for k in mv_names)
    idx_diff = int(np.count_nonzero(ipp.last_planes != cpu.last_planes))
    rmse, rmse_cpu = metrics.rmse(clip, rec), metrics.rmse(clip, rec_cpu)
    require(abs(rmse - rmse_cpu) <= MAX_IPP_RMSE_DIFF,
            f"IPP rmse {rmse} vs CPU run {rmse_cpu}")
    if mv_diff == 0 and idx_diff == 0:
        require(blob == cs_cpu.to_bytes(),
                "equal mvs and indexes but GPU and CPU streams differ")
    split = ipp_split(ipp, clip)
    enc_ms, dec_ms = split["encode"], split["decode"]
    report = {"rmse": rmse, "rmse_cpu": rmse_cpu,
              "bpp": metrics.bpp(cs, clip.shape),
              "cpu_run": f"whole clip, {cpu_s:.1f} s",
              "mv_blocks_differing_from_cpu": mv_diff / mv_total,
              "indexes_differing_from_cpu": idx_diff / ipp.last_planes.size,
              "streams_equal": blob == cs_cpu.to_bytes(),
              "first_run_s": seconds, "warm_encode_ms": enc_ms,
              "warm_decode_ms": dec_ms,
              "gb_per_s": clip.nbytes / ((enc_ms + dec_ms) * 1e-3) / 1e9}
    print(f"ipp clip {n}x{clip.shape[1]}x{clip.shape[2]} grans: "
          f"{json.dumps(report)}")
    print(f"ipp warm split (ms, host clock, synchronized): {json.dumps(split)}")
    return {"sad_search": launches["sad_search"],
            "mc_apply_planar": launches["mc_apply_planar"]}, (blob, rec)


def phase_ctx_kernels(dev, planes: torch.Tensor) -> tuple:
    """3d: the context modes of K1 and K3 at the clip's timing shape."""
    from vcf_tpu_torch.entropy import rans
    from vcf_tpu_torch.ops.cuda import rans_ctx as rc
    from vcf_tpu_torch.ops.cuda import rans_decode as rd
    from vcf_tpu_torch.ops.cuda import rans_encode as re_

    g = 64
    s_streams = rans.RANSCodec._pick_streams(planes.numel(), 65536)
    lanes = rans.subband_lanes_ctx(planes, 8, s_streams)
    l = lanes.shape[1]
    out = {}
    for n_ctx in (4, 15):
        t0 = time.perf_counter()
        fg_np, cg_np = rans.ctx_freqs_from_counts(
            rans.ctx_group_histograms(lanes, g, n_ctx).cpu().numpy())
        t_tables = time.perf_counter() - t0
        fg = torch.from_numpy(fg_np.astype(np.int64)).to(dev)
        cg = torch.from_numpy(cg_np.astype(np.int64)).to(dev)
        raw_k, st_k = rc.rans_encode_ctx(lanes, fg, cg)
        raw_p, st_p = rc.rans_encode_ctx_ref(lanes, fg, cg)
        torch.cuda.synchronize()
        err1 = max(max_abs_err(raw_k, raw_p), max_abs_err(st_k, st_p))
        require(err1 == 0, f"rans_encode_ctx ({n_ctx} classes) differs from "
                f"its plain version by {err1}")
        w_k, n_k, c_k = re_.rans_compact(raw_k)
        w_p, n_p, c_p = re_.rans_compact_ref(raw_p)
        n = int(n_k)
        require(n == int(n_p) and torch.equal(w_k[:n], w_p[:n])
                and torch.equal(c_k, c_p),
                f"K2 words of the context grid ({n_ctx} classes) differ")
        words = w_k[:n].clone()
        out_k = rc.rans_decode_ctx(words, st_k, fg, cg, l, c_k)
        out_p = rc.rans_decode_ctx_ref(words, st_k, fg, cg, l, c_k)
        err3 = max_abs_err(out_k, out_p)
        require(err3 == 0, f"rans_decode_ctx ({n_ctx} classes) differs from "
                f"its plain version by {err3}")
        require(torch.equal(out_k, lanes),
                f"rans_decode_ctx ({n_ctx} classes) output differs from the "
                "lanes")
        mode = rc.decode_table_mode(s_streams, g, n_ctx)
        rows_c = rc.cum_rows(fg, cg, dev)
        lut = torch.from_numpy(rc.class_lut(n_ctx)).to(dev)
        require(torch.equal(rc.rans_decode_ctx(words, st_k, fg, cg, l), lanes),
                f"rans_decode_ctx ({n_ctx} classes) without counts (one "
                "block) differs from the lanes")
        # the encode's launch alone: tables packed, (L, S) copy made before
        packed = re_.pack_tables(fg.reshape(-1, 256), cg.reshape(-1, 256), dev)
        sym_l = lanes.t().contiguous()
        times = {
            "launch_ms": cuda_ms(lambda: re_.launch_encode(
                sym_l, packed, lut, g, n_ctx), 20),
            "ms": cuda_ms(lambda: rc.rans_encode_ctx(lanes, fg, cg), 20),
            "plain_ms": cuda_ms(lambda: rc.rans_encode_ctx_ref(lanes, fg, cg),
                                3),
            "dec_ms": cuda_ms(lambda: rc.rans_decode_ctx(words, st_k, fg, cg,
                                                         l, c_k), 20),
            "dec_launch_ms": cuda_ms(lambda: rd.launch_decode(
                words, st_k, rows_c, lut, c_k, l, g, n_ctx), 20),
            "dec_plain_ms": cuda_ms(lambda: rc.rans_decode_ctx_ref(
                words, st_k, fg, cg, l, c_k), 2)}
        g_tab = g * n_ctx * 256
        times["bound"] = bound(nbytes(lanes, raw_k) + 4 * s_streams + 4 * g_tab)
        times["dec_bound"] = bound(2 * n + 4 * s_streams + 2 * 257 * g * n_ctx
                                   + 256
                                   + 4 * l + nbytes(out_k))
        out[n_ctx] = (err1, err3, mode, times, words,
                      (raw_k, st_k, fg, cg, out_k))
        print(f"ctx kernels: {n_ctx} classes, S={s_streams} L={l} G={g}: "
              f"bit-exact; {n} words, {n * 16 / lanes.numel():.4f} bits/symbol; "
              f"tables {t_tables:.2f} s (host); decode tables in {mode} memory")
        print(f"time rans_encode_ctx ({n_ctx} classes): kernel "
              f"{times['ms']:.4f} ms, plain torch {times['plain_ms']:.4f} ms; "
              f"launch alone {times['launch_ms']:.4f} ms (plan "
              f"{re_.encode_plan(s_streams, g, n_ctx)})")
        print(f"time rans_decode_ctx ({n_ctx} classes, {mode} tables): kernel "
              f"{times['dec_ms']:.4f} ms, plain torch "
              f"{times['dec_plain_ms']:.4f} ms; look-back launch alone "
              f"{times['dec_launch_ms']:.4f} ms")
    rows = []
    for name, src, rep, also, key, err_i in (
            ("rans_encode_ctx", "rans_encode.cu", "rans_ctx.py:256",
             "rans_ctx.py:142", "", 0),
            ("rans_decode_ctx", "rans_decode.cu", "rans_ctx.py:510", None,
             "dec_", 1)):
        t4, t15 = out[4][3], out[15][3]
        extra = {"ms_15_classes": t15[key + "ms"],
                 "plain_ms_15_classes": t15[key + "plain_ms"],
                 "bound_ms_15_classes": t15[key + "bound"]["bound_ms"]}
        extra["launch_ms"] = t4[key + "launch_ms"]
        extra["launch_ms_15_classes"] = t15[key + "launch_ms"]
        if also:
            extra["also_replaces"] = f"vcf_tpu/ops/pallas/{also}"
        else:
            extra["table_mode"] = {"4": out[4][2], "15": out[15][2]}
        rows.append(kernel_row(
            name, src, rep, max(out[c][err_i] for c in (4, 15)),
            t4[key + "ms"], t4[key + "plain_ms"], t4[key + "bound"],
            diff_share=0.0, **extra))
    return rows, out[4][4], {c: out[c][5] for c in (4, 15)}


def phase_cgrans_clip(dev, frames: np.ndarray, planes_k: torch.Tensor,
                      ctx_words: torch.Tensor, grans_clip) -> dict:
    """4d: the 8-frame cgrans clip through IIICodec."""
    from vcf_tpu_torch import CodecConfig
    from vcf_tpu_torch.ops.cuda import dct_kernel as dk
    from vcf_tpu_torch.ops.cuda import rans_ctx as rc
    from vcf_tpu_torch.ops.cuda import rans_encode as re_

    kernels = {"rans_encode_ctx": rc.rans_encode_ctx,
               "rans_compact": re_.rans_compact,
               "rans_decode_ctx": rc.rans_decode_ctx,
               "fused_cdct_quantize": dk.fused_cdct_quantize,
               "fused_dequantize_cdct": dk.fused_dequantize_cdct}
    iii, launches, cs, rec, planes, seconds = run_clip(
        dev, frames, CodecConfig(entropy="cgrans"), kernels)
    print(f"cgrans clip path: launches {launches}")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} was not launched on the cgrans "
                "clip path")
    side = cs["clip.cgrans_model"]
    require(side[0] == 2 and side[1] == 4, "the clip did not take the "
            "4-class context path")
    grans_rec, grans_planes, grans_bpp = grans_clip[:3]
    require(np.array_equal(planes, grans_planes),
            "the cgrans and grans clips coded different planes")
    if np.array_equal(planes, planes_k.cpu().numpy()):
        require(cs["clip.payload"] ==
                ctx_words.cpu().numpy().astype("<u2").tobytes(),
                "the clip's payload differs from phase 3d's 4-class words")
    require(np.array_equal(rec, grans_rec),
            "the cgrans clip's reconstruction differs from the grans clip's")
    report = clip_report(iii, frames, cs, rec, planes, seconds,
                         f"clip {FRAMES}x{H}x{W} cgrans")
    print(f"cgrans clip: {report['bpp']:.6f} bpp against grans "
          f"{grans_bpp:.6f} ({100 * (report['bpp'] / grans_bpp - 1):+.2f}%)")
    return {"rans_encode_ctx": launches["rans_encode_ctx"],
            "rans_decode_ctx": launches["rans_decode_ctx"]}


def phase_dwt(dev, frame: np.ndarray):
    """4e: the 1088x1920 DWT still frame, cgrans and grans; each encode
    launches one DWT analysis kernel a level and each decode one
    synthesis kernel a level, and each the clip path's two ends once
    (colour in and the grid's quantizer on encode, the dequantizer and
    colour out on decode).  Returns the context grid's launches, the DWT
    grid's keys, the DWT level kernels' (analysis, synthesis) launches
    and the ends' launches of the two encodes and decodes."""
    from vcf_tpu_torch import Codec, CodecConfig, CodeStream, metrics
    from vcf_tpu_torch.entropy import dwt_device as dd
    from vcf_tpu_torch.ops.cuda import dwt_ends as dwe
    from vcf_tpu_torch.ops.cuda import dwt_kernel as dwk
    from vcf_tpu_torch.ops.cuda import rans_ctx as rc
    from vcf_tpu_torch.ops.cuda import rans_decode as rd
    from vcf_tpu_torch.ops.cuda import rans_encode as re_

    kernels = {"rans_encode_grouped": re_.rans_encode_grouped,
               "rans_encode_ctx": rc.rans_encode_ctx,
               "rans_compact": re_.rans_compact,
               "rans_decode_grouped": rd.rans_decode_grouped,
               "rans_decode_ctx": rc.rans_decode_ctx}
    expect = {"cgrans": ("rans_encode_ctx", "rans_compact", "rans_decode_ctx"),
              "grans": ("rans_encode_grouped", "rans_compact",
                        "rans_decode_grouped")}
    bank = {"analysis": dwk.analyze_level, "synthesis": dwk.synthesize_level}
    ends = {"dwt_color_in": dwe.color_in,
            "dwt_quantize_grid": dwe.bands_to_lanes,
            "dwt_dequantize_grid": dwe.lanes_to_bands,
            "dwt_color_out": dwe.color_out}
    out, dwt_grid, bank_launches = {}, {}, [0, 0]
    end_launches = dict.fromkeys(ends, 0)
    for ent in ("cgrans", "grans"):
        cfg = CodecConfig(spatial="dwt", qss=DWT_QSS, entropy=ent)
        codec = Codec(cfg, device=dev)
        levels = codec._dwt.levels
        for fn in kernels.values():
            fn.launches = 0
        zero_counts({**bank, **ends})
        t0 = time.perf_counter()
        cs = codec.encode(frame)
        enc_bank = [fn.launches for fn in bank.values()]
        enc_ends = [fn.launches for fn in ends.values()]
        blob = cs.to_bytes()
        zero_counts({**bank, **ends})
        rec = codec.decode(CodeStream.from_bytes(blob))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        dec_bank = [fn.launches for fn in bank.values()]
        dec_ends = [fn.launches for fn in ends.values()]
        launches = {name: fn.launches for name, fn in kernels.items()}
        print(f"dwt {ent} path: launches {launches}, DWT level kernels "
              f"(analysis, synthesis) encode {enc_bank} decode {dec_bank}, "
              f"ends {list(ends)} encode {enc_ends} decode {dec_ends}")
        for name in expect[ent]:
            require(launches[name] > 0,
                    f"kernel {name} was not launched on the DWT {ent} path")
        require(enc_bank == [levels, 0] and dec_bank == [0, levels],
                f"DWT {ent}: level kernels (analysis, synthesis) launched "
                f"{enc_bank} on encode and {dec_bank} on decode, not one a "
                f"level ({levels})")
        require(enc_ends == [1, 1, 0, 0] and dec_ends == [0, 0, 1, 1],
                f"DWT {ent}: the ends {list(ends)} launched {enc_ends} on "
                f"encode and {dec_ends} on decode, not once each")
        bank_launches = [a + e + d for a, e, d in
                         zip(bank_launches, enc_bank, dec_bank)]
        for name, e, d in zip(ends, enc_ends, dec_ends):
            end_launches[name] += e + d
        g, sg, l, *_, n_ctx = dd.unpack_model(cs["gdwt_model"])
        require((g, sg, l) == DWT_GRID, f"DWT grid {(g, sg, l)}")
        require(n_ctx == (4 if ent == "cgrans" else 0),
                f"DWT {ent} stream has {n_ctx} context classes")
        cpu = Codec(cfg, device="cpu")
        t0 = time.perf_counter()
        cs_cpu = cpu.encode(frame)
        rec_cpu = cpu.decode(cs_cpu)
        cpu_s = time.perf_counter() - t0
        grid = dd.bands_to_grid(codec._dwt._grid_bands(codec, frame), sg, l)
        grid_cpu = dd.bands_to_grid(cpu._dwt._grid_bands(cpu, frame), sg, l)
        d = (grid.cpu().to(torch.int64) - grid_cpu.to(torch.int64)).abs()
        # the +-1 rule; a byte plane wraps, so a step of 1 may read as 255
        n_diff = int((d != 0).sum())
        require(bool(((d <= MAX_INDEX_DIFF) | (d == 255)).all())
                and n_diff <= MAX_DIFF_SHARE * d.numel(),
                f"DWT {ent}: {n_diff} lane-grid indexes differ from the CPU")
        if n_diff == 0:
            require(blob == cs_cpu.to_bytes(),
                    f"DWT {ent}: equal indexes but GPU and CPU streams differ")
            require(np.array_equal(rec, rec_cpu),
                    f"DWT {ent}: GPU and CPU reconstructions differ")
        rmse, rmse_cpu = metrics.rmse(frame, rec), metrics.rmse(frame, rec_cpu)
        require(abs(rmse - rmse_cpu) < 1e-3, f"DWT {ent} rmse {rmse} vs CPU "
                f"{rmse_cpu}")
        dwt_grid[expect[ent][0]] = dwt_k1_grid(dev, grid, cs["gdwt_model"])
        if ent == "cgrans":
            ctx_launches, dwt_grid["rans_decode_ctx_grid"] = \
                dwt_ctx_grid_route(dev, codec, frame, cs, grid, rec)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cs_w = codec.encode(frame)
        enc_ms = (time.perf_counter() - t0) * 1e3
        enc_split = {k: v * 1e3 for k, v in codec.last_timings.as_dict().items()}
        t0 = time.perf_counter()
        codec.decode(cs_w)
        dec_ms = (time.perf_counter() - t0) * 1e3
        dec_split = {k: v * 1e3 for k, v in codec.last_timings.as_dict().items()}
        out[ent] = {"rmse": rmse, "rmse_cpu": rmse_cpu,
                    "bpp": metrics.bpp(cs, frame.shape),
                    "grid_indexes_differing_from_cpu": n_diff,
                    "grid_symbols": int(d.numel()), "grid": [g, sg, l],
                    "streams_equal": blob == cs_cpu.to_bytes(),
                    "cpu_run_s": cpu_s, "first_run_s": seconds,
                    "warm_encode_ms": enc_ms, "warm_decode_ms": dec_ms,
                    "encode_split_ms": enc_split, "decode_split_ms": dec_split}
        print(f"dwt {H}x{W} db5 5 levels qss {DWT_QSS} {ent}: "
              f"{json.dumps(out[ent])}")
    print(f"dwt: cgrans {out['cgrans']['bpp']:.6f} bpp against grans "
          f"{out['grans']['bpp']:.6f} "
          f"({100 * (out['cgrans']['bpp'] / out['grans']['bpp'] - 1):+.2f}%)")
    return ctx_launches, dwt_grid, bank_launches, end_launches


def dwt_k1_grid(dev, grid: torch.Tensor, model) -> dict:
    """4e: K1 (order 0 for grans, the context mode for cgrans) on the DWT
    frame's (S, L) = (17 * 512, 3060) lane grid with the stream's tables,
    bit-exact against its plain version; wrapper, launch alone and plain
    times and the bound, as `*_dwt_grid` keys of the kernel's entry."""
    from vcf_tpu_torch.entropy import dwt_device as dd
    from vcf_tpu_torch.ops.cuda import rans_ctx as rc
    from vcf_tpu_torch.ops.cuda import rans_encode as re_

    g, _, l, *_, fg, cg, n_ctx = dd.unpack_model(model)
    fgt = torch.from_numpy(fg.astype(np.int64)).to(dev)
    cgt = torch.from_numpy(cg.astype(np.int64)).to(dev)
    enc, ref = ((rc.rans_encode_ctx, rc.rans_encode_ctx_ref) if n_ctx
                else (re_.rans_encode_grouped, re_.rans_encode_grouped_ref))
    raw, st = enc(grid, fgt, cgt)
    raw_p, st_p = ref(grid, fgt, cgt)
    err = max(max_abs_err(raw, raw_p), max_abs_err(st, st_p))
    require(err == 0, f"K1 ({n_ctx} classes) on the DWT grid differs from "
            f"its plain version by {err}")
    packed = re_.pack_tables(fgt.reshape(-1, 256), cgt.reshape(-1, 256), dev)
    lut = torch.from_numpy(rc.class_lut(n_ctx)).to(dev) if n_ctx else None
    sym_l = grid.t().contiguous()
    s_streams = grid.shape[0]
    out = {"ms_dwt_grid": cuda_ms(lambda: enc(grid, fgt, cgt), 20),
           "launch_ms_dwt_grid": cuda_ms(lambda: re_.launch_encode(
               sym_l, packed, lut, g, n_ctx), 20),
           "plain_ms_dwt_grid": cuda_ms(lambda: ref(grid, fgt, cgt), 2),
           "bound_ms_dwt_grid": bound(nbytes(grid, raw) + 4 * s_streams
                                      + packed.numel() * 4)["bound_ms"],
           "plan_dwt_grid": list(re_.encode_plan(s_streams, g, n_ctx))}
    print(f"time K1 ({n_ctx} classes) on the DWT grid (S={s_streams} L={l} "
          f"G={g}; bit-exact): {json.dumps(out)}")
    return out


def dwt_ctx_grid_route(dev, codec, frame: np.ndarray, cs, grid: torch.Tensor,
                       rec: np.ndarray) -> tuple:
    """4e, device-resident: the DWT frame's context lanes -> the context
    encode's raw grid -> rans_decode_ctx_grid -> synthesis (the decode
    of benchmarks/sweep_tpu.py:326-333); its lanes equal the wire
    decode's and its frame the codec's.  Then the grid decode on that
    (S, L) = (17 * 512, 3060) grid against its plain version, timed
    (wrapper, launch alone, plain) with its bound and plan.  Returns
    (launch counts, the `*_dwt_grid` keys of the kernel's entry)."""
    from vcf_tpu_torch.entropy import dwt_device as dd
    from vcf_tpu_torch.ops.cuda import rans_ctx as rc

    kernels = {"rans_encode_ctx": rc.rans_encode_ctx,
               "rans_decode_ctx_grid": rc.rans_decode_ctx_grid}
    (g, sg, l, n_words, _, states, counts, fg, cg,
     _) = dd.unpack_model(cs["gdwt_model"])
    fgt = torch.from_numpy(fg.astype(np.int64)).to(dev)
    cgt = torch.from_numpy(cg.astype(np.int64)).to(dev)
    dwt = codec._dwt
    zero_counts(kernels)
    raw, st = rc.rans_encode_ctx(grid, fgt, cgt)
    lanes = rc.rans_decode_ctx_grid(raw, st, fgt, cgt, l)
    bands = dd.grid_to_bands(lanes, dwt._grid_sizes(frame.shape), sg)
    rec_dev = dwt._synthesis(codec, dwt._grid_flat(
        codec, bands, dwt._band_shapes(frame.shape)), frame.shape)
    launches = {name: fn.launches for name, fn in kernels.items()}
    print(f"dwt cgrans device-resident path: launches {launches}")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} was not launched on the DWT "
                "device-resident path")
    words = np.frombuffer(cs["gdwt_words"], "<u2")[:n_words]
    wire = dd.decode_grid(words, states, counts, fg, cg, l, dev)
    require(np.array_equal(st.cpu().numpy(), states.astype(np.int64)),
            "the context encode's states differ from the stream's")
    require(torch.equal(lanes, wire) and torch.equal(lanes, grid),
            "rans_decode_ctx_grid's lanes differ from the wire decode's")
    require(np.array_equal(rec_dev, rec),
            "the device-resident DWT frame differs from the codec's")
    print(f"dwt cgrans device-resident route ({g}x{sg} lanes, L={l}): "
          "lanes equal the wire decode's, frame equals the codec's")
    n_ctx = fg.shape[1]
    plain = rc.rans_decode_ctx_grid_ref(raw, st, fgt, cgt, l)
    err = max_abs_err(lanes.t(), plain)
    require(err == 0, f"rans_decode_ctx_grid on the DWT grid differs from "
            f"its plain version by {err}")
    alone = grid_launch_alone(
        "vcf_rans_decode_ctx_grid", raw, st,
        (rc.cum_rows(fgt, cgt, dev), rc.class_lut_on(n_ctx, dev)), l, g,
        n_ctx)
    out = {"ms_dwt_grid": cuda_ms(lambda: rc.rans_decode_ctx_grid(
               raw, st, fgt, cgt, l), 20),
           "launch_ms_dwt_grid": cuda_ms(alone, 20),
           "plain_ms_dwt_grid": cuda_ms(lambda: rc.rans_decode_ctx_grid_ref(
               raw, st, fgt, cgt, l), 1),
           "bound_ms_dwt_grid": bound(
               nbytes(raw, lanes) + 4 * g * sg + 2 * 257 * g * n_ctx
               + 256)["bound_ms"],
           "max_abs_err_dwt_grid": err,
           "plan_dwt_grid": grid_plan(dev, g * sg, g, n_ctx)}
    print(f"time rans_decode_ctx_grid ({n_ctx} classes) on the DWT grid "
          f"(S={g * sg} L={l} G={g}; bit-exact against its plain version): "
          f"{json.dumps(out)}; launch "
          f"{out['launch_ms_dwt_grid'] / out['bound_ms_dwt_grid']:.2f}x the "
          "bound")
    return launches, out


def grid_lanes_of(planes: torch.Tensor):
    """(N, 3, H, W) grid-layout index planes -> ((L, S) lanes, S, cw),
    the lane count as the library picks it (bench.py, bench_ipp.py)."""
    from vcf_tpu_torch.entropy import rans
    from vcf_tpu_torch.ops.cuda import dct_kernel as dk

    s_streams = rans.RANSCodec._pick_streams(planes.numel(), 65536)
    cw = dk._chunk_w(planes.shape[-1], 8)
    return rans.grid_lanes_lmajor(planes, 8, s_streams, cw=cw), s_streams, cw


def grid_tables(dev, lanes_lm: torch.Tensor):
    """(G, 256) tables trained on (L, S) grid lanes, on the device, and
    their numpy freqs."""
    from vcf_tpu_torch.entropy import rans

    fg_np, cg_np = rans.freqs_from_counts(
        rans.group_histograms(lanes_lm.t(), 64).cpu().numpy())
    return (torch.from_numpy(fg_np.astype(np.int64)).to(dev),
            torch.from_numpy(cg_np.astype(np.int64)).to(dev), fg_np)


def grid_launch_alone(entry: str, raw: torch.Tensor, states: torch.Tensor,
                      tables: tuple, l: int, g: int, *extra, lib=None):
    """A call that launches the grid decode's C entry `entry` (of `lib`,
    by default the package's library) alone: the states' int32 copy, the
    output and err made before, no readback (the wrapper's `launch_grid`
    without its host work).  Its `out` and `err` attributes are the
    tensors it writes."""
    from vcf_tpu_torch.ops.cuda import _build
    from vcf_tpu_torch.ops.cuda import rans_encode as re_

    lib = lib or _build.load()
    st32 = re_.u32_as_i32(states.to(torch.int64)).contiguous()
    out = torch.empty((l, st32.numel()), dtype=torch.uint8, device=raw.device)
    err = torch.zeros(1, dtype=torch.int32, device=raw.device)
    stream = _build.stream_of(raw)

    def call():
        _build.check(getattr(lib, entry)(
            raw.data_ptr(), st32.data_ptr(), *[t.data_ptr() for t in tables],
            out.data_ptr(), err.data_ptr(), st32.numel(), l, g, *extra,
            stream), entry)
    call.out, call.err = out, err
    return call


def grid_plan(dev, s_streams: int, g: int, n_ctx: int) -> dict:
    """The grid decode's plan on this card (its C entry), which must equal
    the Python mirror's."""
    from vcf_tpu_torch.ops.cuda import rans_decode as rd

    plan = rd.decode_plan(s_streams, g, n_ctx)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    require(plan == rd.decode_plan_for(s_streams, g, n_ctx, sms),
            f"decode_plan({s_streams}, {g}, {n_ctx}) differs from its Python "
            "mirror")
    return plan


def phase_grid_kernels(dev, frames: np.ndarray, ctx_grids: dict) -> list:
    """3e: the lane-grid modes at full size against their plain versions."""
    from vcf_tpu_torch.ops import color as color_ops
    from vcf_tpu_torch.ops.cuda import dct_kernel as dk
    from vcf_tpu_torch.ops.cuda import rans_ctx as rc
    from vcf_tpu_torch.ops.cuda import rans_decode as rd
    from vcf_tpu_torch.ops.cuda import rans_encode as re_

    b = 8
    x = torch.from_numpy(frames).to(dev)
    px = x.permute(0, 3, 1, 2).contiguous()
    ct = color_ops.ycocg_forward(x.to(torch.float32) - 128
                                 ).permute(0, 3, 1, 2).contiguous()
    mf = dk.static_mat(color_ops.YCOCG_FWD)
    mi = dk.static_mat(color_ops.YCOCG_INV)
    k3 = dk.fused_cdct_quantize(px, mf, grid_layout=True)
    k3_blk = dk.fused_cdct_quantize(px, mf)
    require(torch.equal(k3, dk.to_grid(k3_blk, b)),
            "B3 grid mode differs from the block mode permuted")
    b3 = diff_rule(k3, dk.fused_cdct_quantize_ref(px, mf, grid_layout=True),
                   "B3 grid")
    p4 = dk.fused_dequantize_cdct(k3, mi, grid_layout=True)
    require(torch.equal(p4, dk.fused_dequantize_cdct(k3_blk, mi)),
            "B4 grid mode differs from the block mode on the same indexes")
    b4 = diff_rule(p4, dk.fused_dequantize_cdct_ref(k3, mi, grid_layout=True),
                   "B4 grid")
    b12 = {}
    for perc in (False, True):
        k1 = dk.fused_dct_quantize(ct, perceptual=perc, grid_layout=True)
        require(torch.equal(k1, dk.to_grid(
            dk.fused_dct_quantize(ct, perceptual=perc), b)),
            f"B1 grid mode (perceptual={perc}) differs from the block mode "
            "permuted")
        b1 = diff_rule(k1, dk.fused_dct_quantize_ref(
            ct, perceptual=perc, grid_layout=True), f"B1 grid perc={perc}")
        x2 = dk.fused_dequantize_idct(k1, perceptual=perc, grid_layout=True)
        require(torch.equal(x2, dk.fused_dequantize_idct(
            dk.from_grid(k1, b), perceptual=perc)),
            f"B2 grid mode (perceptual={perc}) differs from the block mode")
        err2 = float((x2 - dk.fused_dequantize_idct_ref(
            k1, perceptual=perc, grid_layout=True)).abs().max())
        require(err2 <= MAX_PLANE_ERR, f"B2 grid perceptual={perc} differs "
                f"from its plain version by {err2}")
        b12[perc] = (k1, b1, (err2, 0.0))
    print(f"grid kernels: B1-B4 grid modes = block modes permuted, bit for "
          f"bit; against plain: B3 max {b3[0]} share {b3[1]:.3e}, B4 max "
          f"{b4[0]} share {b4[1]:.3e}, B1 perceptual max {b12[True][1][0]} "
          f"share {b12[True][1][1]:.3e}, B2 perceptual max "
          f"{b12[True][2][0]:.3e}")

    lanes, s_streams, cw = grid_lanes_of(k3)
    l = lanes.shape[0]
    fg, cg, _ = grid_tables(dev, lanes)
    # the (L, S) lanes reach K1 as their transposed view (strided: K1's
    # wrapper makes it contiguous) and as a contiguous (S, L) copy
    raw, st = re_.rans_encode_grouped(lanes.t(), fg, cg)
    raw_t, st_t = re_.rans_encode_grouped(lanes.t().contiguous(), fg, cg)
    raw_p, st_p = re_.rans_encode_grouped_ref(lanes.t(), fg, cg)
    err_k1 = max(max_abs_err(raw, raw_p), max_abs_err(st, st_p))
    require(err_k1 == 0 and torch.equal(raw, raw_t) and torch.equal(st, st_t),
            f"K1 on the (L, S) lanes differs from its plain version "
            f"({err_k1}) or from K1 on an (S, L) copy")
    rows, counts, st_r = re_.rans_encode_rows(lanes.t(), fg, cg)
    rows_p, counts_p = re_.rans_compact_rows_ref(raw)
    # only each row's prefix is defined; the plain version zeroes the tail
    prefix = torch.arange(s_streams, device=dev) < counts[:, None]
    err_rows = max(max_abs_err(rows.masked_fill(~prefix, 0), rows_p),
                   max_abs_err(counts, counts_p))
    require(err_rows == 0 and torch.equal(st_r, st),
            f"the row mode of K2 differs from its plain version by {err_rows}")
    words, n_words = re_.assemble_stream(rows, counts)
    w2, n2, c2 = re_.rans_compact(raw)
    n = int(n_words)
    require(n == int(n2) and torch.equal(words[:n], w2[:n])
            and torch.equal(counts, c2),
            "assemble_stream's words differ from K2's on the same grid")
    dec = rd.rans_decode_grouped_grid(raw, st, fg, cg, l).t()
    dec_p = rd.rans_decode_grouped_grid_ref(raw, st, fg, cg, l)   # (L, S)
    err_dec = max_abs_err(dec, dec_p)
    require(err_dec == 0 and torch.equal(dec, lanes) and dec.is_contiguous(),
            f"the grid decode differs from its plain version ({err_dec}) or "
            "from the encoded lanes")
    wire = words[:n].clone()
    require(torch.equal(rd.rans_decode_grouped(wire, st, fg, cg, l, counts
                                               ).t(), lanes),
            "K3's output differs from the lanes")
    print(f"grid kernels: S={s_streams} L={l} cw={cw}: K1 on the (L, S) "
          f"lanes, the row mode, assemble_stream ({n} words), the grid "
          "decode and K3 bit-exact")
    k1_bnd = bound(nbytes(lanes, raw) + 4 * s_streams + 64 * 256 * 4)
    print(f"time rans_encode_grouped on the (L, S) lanes' view: kernel "
          f"{cuda_ms(lambda: re_.rans_encode_grouped(lanes.t(), fg, cg), 20):.4f}"
          f" ms, plain torch "
          f"{cuda_ms(lambda: re_.rans_encode_grouped_ref(lanes.t(), fg, cg), 3):.4f}"
          f" ms, bound {k1_bnd['bound_ms']:.4f} ms ({k1_bnd['bound_by']})")
    ctx_out = {}
    for n_ctx, (raw_c, st_c, fgc, cgc, lanes_c) in ctx_grids.items():
        out_c = rc.rans_decode_ctx_grid(raw_c, st_c, fgc, cgc, l)
        out_cp = rc.rans_decode_ctx_grid_ref(raw_c, st_c, fgc, cgc, l)
        err_c = max_abs_err(out_c, out_cp.t())
        require(err_c == 0 and torch.equal(out_c, lanes_c),
                f"rans_decode_ctx_grid ({n_ctx} classes) differs from its "
                f"plain version ({err_c}) or from rans_decode_ctx's output")
        g_rows = fgc.shape[0] * n_ctx * 257 * 2
        # the launch alone: cumulative rows and class LUT made before
        alone = grid_launch_alone(
            "vcf_rans_decode_ctx_grid", raw_c, st_c,
            (rc.cum_rows(fgc, cgc, dev), rc.class_lut_on(n_ctx, dev)), l,
            fgc.shape[0], n_ctx)
        ctx_out[n_ctx] = (err_c, {
            "ms": cuda_ms(lambda: rc.rans_decode_ctx_grid(
                raw_c, st_c, fgc, cgc, l), 20),
            "launch_ms": cuda_ms(alone, 20),
            "plain_ms": cuda_ms(lambda: rc.rans_decode_ctx_grid_ref(
                raw_c, st_c, fgc, cgc, l), 2),
            "plan": grid_plan(dev, s_streams, fgc.shape[0], n_ctx),
            "bound": bound(nbytes(raw_c, out_c) + 4 * s_streams + g_rows
                           + 256)})
    print("grid kernels: rans_decode_ctx_grid (4 and 15 classes) bit-exact "
          "against its plain version and rans_decode_ctx on 3d's grids")

    n_el = k3.numel()
    tab = 64 * 256 * 4
    k1p = b12[True][0]
    # B1/B2 perceptual: the benchmark's count, and 1 an element for the
    # perceptual multiply
    rows_spec = [
        ("fused_dct_quantize", "dct.cu", "dct_kernel.py:153", b12[True][1],
         lambda: dk.fused_dct_quantize(ct, perceptual=True, grid_layout=True),
         lambda: dk.fused_dct_quantize_ref(ct, perceptual=True,
                                           grid_layout=True), 20, 5,
         bound(nbytes(ct, k1p),
               n_el * (work.dct_ops_per_elem(8, color=False) + 1))),
        ("fused_dequantize_idct", "dct.cu", "dct_kernel.py:207", b12[True][2],
         lambda: dk.fused_dequantize_idct(k1p, perceptual=True,
                                          grid_layout=True),
         lambda: dk.fused_dequantize_idct_ref(k1p, perceptual=True,
                                              grid_layout=True), 20, 5,
         bound(nbytes(k1p, ct),
               n_el * (work.dct_ops_per_elem(8, color=False) + 1))),
        ("fused_cdct_quantize", "dct.cu", "dct_kernel.py:298", b3,
         lambda: dk.fused_cdct_quantize(px, mf, grid_layout=True),
         lambda: dk.fused_cdct_quantize_ref(px, mf, grid_layout=True), 20, 5,
         bound(nbytes(px, k3), n_el * work.dct_ops_per_elem(8, color=True))),
        ("fused_dequantize_cdct", "dct.cu", "dct_kernel.py:334", b4,
         lambda: dk.fused_dequantize_cdct(k3, mi, grid_layout=True),
         lambda: dk.fused_dequantize_cdct_ref(k3, mi, grid_layout=True),
         20, 5,
         bound(nbytes(k3, px), n_el * work.dct_ops_per_elem(8, color=True))),
        # the function's output is each row's prefix: n words and counts
        ("rans_compact_rows", "rans_encode.cu", "rans_encode.py:496",
         (err_rows, 0.0), lambda: re_.rans_compact_rows(raw),
         lambda: re_.rans_compact_rows_ref(raw), 20, 5,
         bound(nbytes(raw, counts) + 2 * n)),
        ("rans_decode_grouped_grid", "rans_grid.cu", "rans_decode.py:349",
         (err_dec, 0.0), lambda: rd.rans_decode_grouped_grid(
             raw, st, fg, cg, l),
         lambda: rd.rans_decode_grouped_grid_ref(raw, st, fg, cg, l), 20, 2,
         bound(nbytes(raw, dec) + 4 * s_streams + tab)),
    ]
    modes = ["grid_layout"] * 4 + ["rows", "grid"]
    also = {"rans_compact_rows": "vcf_tpu/ops/pallas/rans_encode.py:613"}
    # B3/B4's grid modes also run on 2 frames a launch: the planar IPP
    # loop's GOP batch (phase 4g)
    px2, k32 = px[:2], k3[:2]
    two_frames = {
        "fused_cdct_quantize": lambda: dk.fused_cdct_quantize(
            px2, mf, grid_layout=True),
        "fused_dequantize_cdct": lambda: dk.fused_dequantize_cdct(
            k32, mi, grid_layout=True)}
    results = []
    for mode, (name, src, rep, (err, share), kern, plain, reps_k, reps_p,
               bnd) in zip(modes, rows_spec):
        ms, plain_ms = cuda_ms(kern, reps_k), cuda_ms(plain, reps_p)
        extra = {"also_replaces": also[name]} if name in also else {}
        if mode == "grid_layout" and name in two_frames:
            extra["ms_2_frames"] = cuda_ms(two_frames[name], 20)
        if name == "rans_decode_grouped_grid":
            # the launch alone: tables packed before
            extra["launch_ms"] = cuda_ms(grid_launch_alone(
                "vcf_rans_decode_grid", raw, st,
                (re_.pack_tables(fg, cg, dev),), l, fg.shape[0]), 20)
            extra["plan"] = grid_plan(dev, s_streams, fg.shape[0], 0)
        print(f"time {name} [{mode}]: kernel {ms:.4f} ms, plain torch "
              f"{plain_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']}), {ms / bnd['bound_ms']:.2f}x the bound"
              + (f"; 2 frames {extra['ms_2_frames']:.4f} ms "
                 f"({FRAMES / 2 * extra['ms_2_frames'] / bnd['bound_ms']:.2f}"
                 "x)"
                 if "ms_2_frames" in extra else "")
              + (f"; launch alone {extra['launch_ms']:.4f} ms "
                 f"({extra['launch_ms'] / bnd['bound_ms']:.2f}x), plan "
                 f"{extra['plan']}" if "launch_ms" in extra else ""))
        # a mode of a wrapper that has an entry of its own is named apart
        shared = mode == "grid_layout"
        results.append(kernel_row(f"{name}[{mode}]" if shared else name, src,
                                  rep, err, ms, plain_ms, bnd, mode=mode,
                                  diff_share=share, **extra))
    print_plain_mode(dk, ct, b12[False][0], grid_layout=True)
    c4, c15 = ctx_out[4][1], ctx_out[15][1]
    for n_ctx, (_, t) in ctx_out.items():
        print(f"time rans_decode_ctx_grid ({n_ctx} classes): kernel "
              f"{t['ms']:.4f} ms, launch alone {t['launch_ms']:.4f} ms, "
              f"plain torch {t['plain_ms']:.4f} ms, bound "
              f"{t['bound']['bound_ms']:.4f} ms ({t['bound']['bound_by']}), "
              f"launch {t['launch_ms'] / t['bound']['bound_ms']:.2f}x the "
              f"bound; plan {t['plan']}")
    results.append(kernel_row(
        "rans_decode_ctx_grid", "rans_grid.cu", "rans_ctx.py:415",
        max(ctx_out[4][0], ctx_out[15][0]), c4["ms"], c4["plain_ms"],
        c4["bound"], mode="grid", diff_share=0.0, launch_ms=c4["launch_ms"],
        plan=c4["plan"], ms_15_classes=c15["ms"],
        launch_ms_15_classes=c15["launch_ms"],
        plain_ms_15_classes=c15["plain_ms"],
        bound_ms_15_classes=c15["bound"]["bound_ms"],
        plan_15_classes=c15["plan"]))
    return results


def grid_clip_route(dev, fg, cg, l: int, s_streams: int, cw: int,
                    n: int, h: int, w: int):
    """bench.py's lane-grid composition for (N, H, W, 3) u8 frames on the
    device: the device-resident route (encode_dev, decode_dev) and the
    wire route (encode_wire, decode_wire), B3/B4 in the grid layout."""
    from vcf_tpu_torch.entropy import rans
    from vcf_tpu_torch.ops import color as color_ops
    from vcf_tpu_torch.ops.cuda import dct_kernel as dk
    from vcf_tpu_torch.ops.cuda import rans_decode as rd
    from vcf_tpu_torch.ops.cuda import rans_encode as re_

    mf = dk.static_mat(color_ops.YCOCG_FWD)
    mi = dk.static_mat(color_ops.YCOCG_INV)

    def lanes_of(x):
        planes = dk.fused_cdct_quantize(x.permute(0, 3, 1, 2), mf,
                                        grid_layout=True)
        return rans.grid_lanes_lmajor(planes, 8, s_streams, cw=cw)

    def frames_of(lanes_lm):
        planes = rans.grid_unlanes_lmajor(lanes_lm, 8, (n, 3, h, w), cw=cw)
        return dk.fused_dequantize_cdct(planes, mi, grid_layout=True
                                        ).permute(0, 2, 3, 1)

    def encode_dev(x):
        return re_.rans_encode_grouped(lanes_of(x).t(), fg, cg)

    def decode_dev(raw, st):
        return frames_of(rd.rans_decode_grouped_grid(raw, st, fg, cg, l).t())

    def encode_wire(x, cap):
        rows, counts, st = re_.rans_encode_rows(lanes_of(x).t(), fg, cg)
        words, n_words = re_.assemble_stream(rows[:, :cap], counts)
        return words, n_words, st, counts

    def decode_wire(words, n_words, st, counts):
        return frames_of(rd.rans_decode_grouped(
            words[:int(n_words)], st, fg, cg, l, counts).t())

    return encode_dev, decode_dev, encode_wire, decode_wire, lanes_of, frames_of


def phase_grid_clip(dev, frames: np.ndarray, grans_clip, perceptual_rec
                    ) -> dict:
    """4f: the 8-frame grans clip on the lane-grid path (bench.py:317-421),
    then the 2-frame perceptual clip through the B1/B2 grid modes."""
    import zlib

    from vcf_tpu_torch import metrics
    from vcf_tpu_torch.config import CodecConfig
    from vcf_tpu_torch.entropy import rans
    from vcf_tpu_torch.ops import color as color_ops
    from vcf_tpu_torch.ops.cuda import dct_kernel as dk
    from vcf_tpu_torch.ops.cuda import rans_decode as rd
    from vcf_tpu_torch.ops.cuda import rans_encode as re_
    from vcf_tpu_torch.parallel import BatchCodec
    from vcf_tpu_torch.parallel.mesh import _on_device

    kernels = {"fused_cdct_quantize": dk.fused_cdct_quantize,
               "fused_dequantize_cdct": dk.fused_dequantize_cdct,
               "rans_encode_grouped": re_.rans_encode_grouped,
               "rans_compact_rows": re_.rans_compact_rows,
               "rans_decode_grouped_grid": rd.rans_decode_grouped_grid,
               "rans_decode_grouped": rd.rans_decode_grouped}
    n, h, w, _ = frames.shape
    x = torch.from_numpy(frames).to(dev)
    # set-up, as bench.py: the tables trained once on the clip's lanes,
    # and the wire route's column cap from a probe (sweep_tpu.py's rule)
    lanes0, s_streams, cw = grid_lanes_of(dk.fused_cdct_quantize(
        x.permute(0, 3, 1, 2), dk.static_mat(color_ops.YCOCG_FWD),
        grid_layout=True))
    l = lanes0.shape[0]
    fg, cg, fg_np = grid_tables(dev, lanes0)
    _, counts0, _ = re_.rans_encode_rows(lanes0.t(), fg, cg)
    cap = min(max(-(-int(counts0.max()) * 2 // 128) * 128, 128), s_streams)
    (encode_dev, decode_dev, encode_wire, decode_wire, lanes_of,
     frames_of) = grid_clip_route(dev, fg, cg, l, s_streams, cw, n, h, w)

    zero_counts(kernels)
    raw, st = encode_dev(x)
    rec_dev = decode_dev(raw, st)
    words, n_words, st_w, counts = encode_wire(x, cap)
    rec_wire = decode_wire(words, n_words, st_w, counts)
    torch.cuda.synchronize()
    launches = {"fused_cdct_quantize": dk.fused_cdct_quantize.grid_launches,
                "fused_dequantize_cdct":
                    dk.fused_dequantize_cdct.grid_launches,
                "rans_encode_grouped": re_.rans_encode_grouped.launches,
                "rans_compact_rows": re_.rans_compact_rows.launches,
                "rans_decode_grouped_grid":
                    rd.rans_decode_grouped_grid.launches,
                "rans_decode_grouped": rd.rans_decode_grouped.launches}
    print(f"lane-grid clip path: launches {launches}")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} was not launched on the lane-grid "
                "clip path")
    nw = int(n_words)
    w2, n2, c2 = re_.rans_compact(raw)
    require(nw == int(n2) and torch.equal(words[:nw], w2[:nw])
            and torch.equal(st_w, st) and torch.equal(counts, c2),
            "the wire route's words differ from K2's on the raw grid")
    rec_np = rec_dev.cpu().numpy()
    require(torch.equal(rec_dev, rec_wire),
            "the device-resident and wire routes reconstruct different frames")
    grans_rec = grans_clip[0]
    require(np.array_equal(rec_np, grans_rec),
            "the lane-grid clip's frames differ from the IIICodec clip's")
    side = (4 * s_streams + len(zlib.compress(fg_np.astype("<u2").tobytes(), 9))
            + len(zlib.compress(counts.cpu().numpy().astype("<u4").tobytes(),
                                9)))
    times = {
        "device_encode_ms": cuda_ms(lambda: encode_dev(x), 5),
        "device_decode_ms": cuda_ms(lambda: decode_dev(raw, st), 3),
        "wire_encode_ms": cuda_ms(lambda: encode_wire(x, cap), 5),
        "wire_decode_ms": cuda_ms(
            lambda: decode_wire(words, n_words, st_w, counts), 3),
        # the split: B3 grid + laning, and unlaning + B4 grid
        "b3_and_lanes_ms": cuda_ms(lambda: lanes_of(x), 5),
        "unlanes_and_b4_ms": cuda_ms(lambda: frames_of(lanes0), 5)}
    # the wire encode split: B3 grid + laning (above), K1 (wrapper and
    # launch alone), the row mode, assemble_stream (CUDA events; it reads
    # the counts back with .cpu(), a host sync, so its time holds that
    # round trip), and the whole and assemble_stream by the host clock.
    # The (L, S) lanes are a strided view of an (S, L) copy, so K1's
    # wrapper makes them contiguous: `lanes_copy` times that copy.
    lanes_x = lanes_of(x)
    lanes_c = lanes_x.contiguous()
    raw_x, _ = re_.rans_encode_grouped(lanes_x.t(), fg, cg)
    rows_x, counts_x = re_.rans_compact_rows(raw_x)
    packed = re_.pack_tables(fg, cg, dev)
    times["lanes_contiguous"] = lanes_x.is_contiguous()
    times["wire_encode_split_ms"] = {
        "k1": cuda_ms(lambda: re_.rans_encode_grouped(lanes_x.t(), fg, cg),
                      5),
        "lanes_copy": cuda_ms(lambda: lanes_x.contiguous(), 5),
        "k1_launch": cuda_ms(lambda: re_.launch_encode(
            lanes_c, packed, None, fg.shape[0], 0), 5),
        "rows": cuda_ms(lambda: re_.rans_compact_rows(raw_x), 5),
        "assemble_stream": cuda_ms(
            lambda: re_.assemble_stream(rows_x[:, :cap], counts_x), 5),
        "assemble_stream_host": host_ms(
            lambda: re_.assemble_stream(rows_x[:, :cap], counts_x), 5),
        "wire_encode_host": host_ms(lambda: encode_wire(x, cap), 5)}
    report = {"rmse": metrics.rmse(frames, rec_np),
              "wire_bpp": (2 * nw + side) * 8 / (n * h * w),
              "iii_clip_bpp": grans_clip[2], "n_words": nw, "cap": cap,
              "lanes": [s_streams, l], "cw": cw, **times,
              "device_gb_per_s": frames.nbytes / (
                  (times["device_encode_ms"] + times["device_decode_ms"])
                  * 1e6),
              "wire_gb_per_s": frames.nbytes / (
                  (times["wire_encode_ms"] + times["wire_decode_ms"]) * 1e6)}
    print(f"lane-grid clip {n}x{h}x{w} grans (frames equal the IIICodec "
          f"clip's; CUDA events, warm): {json.dumps(report)}")

    # the perceptual lane-grid clip: BatchCodec's colour in torch around
    # the B1/B2 grid modes, on the frames as BatchCodec uploads them
    p_kernels = {"fused_dct_quantize": dk.fused_dct_quantize,
                 "fused_dequantize_idct": dk.fused_dequantize_idct,
                 **kernels}
    pn = len(perceptual_rec)
    bc = BatchCodec(CodecConfig(entropy="grans", perceptual=True), dev)
    ctp = bc._fwd(_on_device(frames[:pn], dev).to(torch.float32) - 128
                  ).permute(0, 3, 1, 2).contiguous()
    lanes_p, _, cw_p = grid_lanes_of(dk.fused_dct_quantize(
        ctp, perceptual=True, grid_layout=True))
    fgp, cgp, _ = grid_tables(dev, lanes_p)
    zero_counts(p_kernels)
    planes = dk.fused_dct_quantize(ctp, perceptual=True, grid_layout=True)
    lanes_e, _, _ = grid_lanes_of(planes)
    raw_p, st_p = re_.rans_encode_grouped(lanes_e.t(), fgp, cgp)
    back = rd.rans_decode_grouped_grid(raw_p, st_p, fgp, cgp,
                                       lanes_e.shape[0]).t()
    ct_d = dk.fused_dequantize_idct(rans.grid_unlanes_lmajor(
        back, 8, planes.shape, cw=cw_p), perceptual=True, grid_layout=True)
    y = bc._inv(ct_d.permute(0, 2, 3, 1)) + 128
    rec_p = torch.clamp(torch.round(y), 0, 255).to(torch.uint8).cpu().numpy()
    p_launches = {
        "fused_dct_quantize": dk.fused_dct_quantize.grid_launches,
        "fused_dequantize_idct": dk.fused_dequantize_idct.grid_launches,
        "rans_encode_grouped": re_.rans_encode_grouped.launches,
        "rans_decode_grouped_grid": rd.rans_decode_grouped_grid.launches}
    print(f"perceptual lane-grid clip path: launches {p_launches}")
    for name, count in p_launches.items():
        require(count > 0, f"kernel {name} was not launched on the "
                "perceptual lane-grid clip path")
    require(np.array_equal(rec_p, perceptual_rec),
            "the perceptual lane-grid clip's frames differ from the "
            "perceptual IIICodec clip's")
    print(f"perceptual lane-grid clip {pn}x{h}x{w}: frames equal the "
          "perceptual IIICodec clip's")
    return launches, p_launches


def gop_encode_split(enc, gops: torch.Tensor) -> tuple:
    """CUDA-event split of one planar grid GOP-loop encode `enc(gops)` into
    its luma, SAD, MC and B3/B4 calls (events recorded around each call,
    through timing wrappers swapped in for the module functions the loop
    calls, for this run only) and the rest (clip, round, stacks); and the
    (ref, cur) lumas of its SAD calls."""
    from vcf_tpu_torch.ops.cuda import dct_kernel as dk
    from vcf_tpu_torch.ops.cuda import luma_kernel as lk
    from vcf_tpu_torch.ops.cuda import mc_kernel as mk
    from vcf_tpu_torch.ops.cuda import sad_kernel as sk

    targets = {"luma": (lk, "luma"), "SAD": (sk, "sad_search"),
               "MC": (mk, "mc_apply_planar"),
               "B3 grid": (dk, "fused_cdct_quantize"),
               "B4 grid": (dk, "fused_dequantize_cdct")}
    events = {key: [] for key in targets}
    lumas = []

    def timed(key, fn):
        def call(*args, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*args, **kw)
            ev[1].record()
            events[key].append(ev)
            if key == "SAD":
                lumas.append(args[:2])
            return out
        # the wrappers count their launches on their module's name
        for attr in COUNTS:
            if hasattr(fn, attr):
                setattr(call, attr, 0)
        return call

    saved = {key: getattr(mod, name) for key, (mod, name) in targets.items()}
    for key, (mod, name) in targets.items():
        setattr(mod, name, timed(key, saved[key]))
    try:
        enc(gops)        # warm: the wrappers' first calls
        for ev in events.values():
            ev.clear()
        lumas.clear()
        torch.cuda.synchronize()
        whole = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        whole[0].record()
        enc(gops)
        whole[1].record()
        torch.cuda.synchronize()
    finally:
        for key, (mod, name) in targets.items():
            setattr(mod, name, saved[key])
    missing = [key for key, ev in events.items() if not ev]
    require(not missing and lumas,
            f"GOP-loop split: no call of {missing} was timed (the loop "
            "calls it by a name the split does not intercept)")
    split = {key: sum(a.elapsed_time(b) for a, b in ev)
             for key, ev in events.items()}
    split["other"] = whole[0].elapsed_time(whole[1]) - sum(split.values())
    split["whole"] = whole[0].elapsed_time(whole[1])
    return split, lumas


def ipp_grid_route(dev, clip: np.ndarray) -> tuple:
    """Phase 4g's set-up, as benchmarks/bench_ipp.py: the planar IPP codec
    on `dev`, the clip's GOP batch, rANS tables trained once on its planes,
    and the whole encode (GOP loop, laning, K1) and decode (grid decode,
    unlaning, GOP loop).  Returns (ipp, gops, encode_full, decode_full,
    fg_np, s_streams)."""
    from vcf_tpu_torch import CodecConfig, video
    from vcf_tpu_torch.config import VideoConfig
    from vcf_tpu_torch.entropy import rans
    from vcf_tpu_torch.ops.cuda import rans_decode as rd
    from vcf_tpu_torch.ops.cuda import rans_encode as re_

    n, h, w, _ = clip.shape
    vcfg = VideoConfig(mode="ipp", n_frames=n, gop_size=GOP,
                       me_block=ME_BLOCK, search_range=SEARCH)
    ipp = video.get(vcfg, CodecConfig(entropy="grans", subbands=False), dev)
    enc, dec = ipp._gop_encode_grid_batch, ipp._gop_decode_grid_batch
    gops = torch.from_numpy(clip).to(dev).reshape(-1, GOP, h, w, 3)
    planes0, _ = enc(gops)
    lanes0, s_streams, cw = grid_lanes_of(planes0.reshape(-1, 3, h, w))
    l = lanes0.shape[0]
    fg, cg, fg_np = grid_tables(dev, lanes0)

    def encode_full(g):
        planes, mvs = enc(g)
        lanes, _, _ = grid_lanes_of(planes.reshape(-1, 3, h, w))
        raw, st = re_.rans_encode_grouped(lanes.t(), fg, cg)
        return planes, mvs, raw, st

    def decode_full(raw, st, mvs):
        lanes = rd.rans_decode_grouped_grid(raw, st, fg, cg, l).t()
        planes = rans.grid_unlanes_lmajor(lanes, 8, (n, 3, h, w), cw=cw)
        return dec(planes.reshape(-1, GOP, 3, h, w), mvs)

    return ipp, gops, encode_full, decode_full, fg_np, s_streams


def phase_ipp_grid(dev, clip: np.ndarray) -> dict:
    """4g: IPPCodec's planar grid loop (benchmarks/bench_ipp.py:57-172)."""
    import zlib

    from vcf_tpu_torch import metrics, video
    from vcf_tpu_torch.ops.cuda import dct_kernel as dk
    from vcf_tpu_torch.ops.cuda import luma_kernel as lk
    from vcf_tpu_torch.ops.cuda import mc_kernel as mk
    from vcf_tpu_torch.ops.cuda import rans_decode as rd
    from vcf_tpu_torch.ops.cuda import rans_encode as re_
    from vcf_tpu_torch.ops.cuda import sad_kernel as sk

    kernels = {"luma": lk.luma, "sad_search": sk.sad_search,
               "mc_apply_planar": mk.mc_apply_planar,
               "fused_cdct_quantize": dk.fused_cdct_quantize,
               "fused_dequantize_cdct": dk.fused_dequantize_cdct,
               "rans_encode_grouped": re_.rans_encode_grouped,
               "rans_decode_grouped_grid": rd.rans_decode_grouped_grid}
    n, h, w, _ = clip.shape
    ipp, gops, encode_full, decode_full, fg_np, s_streams = ipp_grid_route(
        dev, clip)
    enc, dec = ipp._gop_encode_grid_batch, ipp._gop_decode_grid_batch

    zero_counts(kernels)
    planes, mvs, raw, st = encode_full(gops)
    recs = decode_full(raw, st, mvs)
    torch.cuda.synchronize()
    launches = {"luma": lk.luma.launches,
                "sad_search": sk.sad_search.launches,
                "mc_apply_planar": mk.mc_apply_planar.launches,
                "fused_cdct_quantize": dk.fused_cdct_quantize.grid_launches,
                "fused_dequantize_cdct":
                    dk.fused_dequantize_cdct.grid_launches,
                "rans_encode_grouped": re_.rans_encode_grouped.launches,
                "rans_decode_grouped_grid":
                    rd.rans_decode_grouped_grid.launches}
    print(f"ipp grid path: launches {launches}")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} was not launched on the IPP grid "
                "path")
    require_ipp_modes("IPP grid path")
    # each launch takes the whole GOP batch: two a P step
    p_steps = planes.shape[1] - 1
    require(lk.luma.launches == 2 * p_steps and lk.luma.generic_launches == 0,
            f"IPP grid path: {lk.luma.launches} luma launches "
            f"({lk.luma.generic_launches} scalar) for {p_steps} P steps, not "
            "two in the vector modes a step")
    require(torch.equal(recs, ipp.last_grid_recon),
            "the grid decoder differs from the encoder's reconstruction")
    rec = torch.clamp(torch.round(recs), 0, 255).to(torch.uint8).permute(
        0, 1, 3, 4, 2).reshape(n, h, w, 3).cpu().numpy()

    cpu = video.get(ipp.vcfg, ipp.ccfg, "cpu")
    t0 = time.perf_counter()
    planes_c, mvs_c = cpu._gop_encode_grid_batch(
        torch.from_numpy(clip).reshape(-1, GOP, h, w, 3))
    cpu_s = time.perf_counter() - t0
    mv_diff = int((mvs.cpu() != mvs_c).any(-1).sum())
    d = (planes.cpu().to(torch.int64) - planes_c.to(torch.int64)).abs()
    idx_diff = int((d != 0).sum())
    require(int(d.max()) <= 1 and idx_diff <= MAX_IPP_DIFF_SHARE * d.numel(),
            f"IPP grid indexes vs the CPU run: {idx_diff} differ, max "
            f"{int(d.max())}")
    rec_c = torch.clamp(torch.round(cpu.last_grid_recon), 0, 255).to(
        torch.uint8).permute(0, 1, 3, 4, 2).reshape(n, h, w, 3).numpy()
    rmse, rmse_cpu = metrics.rmse(clip, rec), metrics.rmse(clip, rec_c)
    require(abs(rmse - rmse_cpu) <= MAX_IPP_RMSE_DIFF,
            f"IPP grid rmse {rmse} vs CPU run {rmse_cpu}")
    _, nw, counts = re_.rans_compact(raw)
    side = (4 * s_streams + len(zlib.compress(fg_np.astype("<u2").tobytes(), 9))
            + len(zlib.compress(counts.cpu().numpy().astype("<u4").tobytes(),
                                9)))
    mv_bytes = mvs.numel()                     # int8 per component
    enc_ms = cuda_ms(lambda: encode_full(gops), 3)
    dec_ms = cuda_ms(lambda: decode_full(raw, st, mvs), 3)
    loop_ms = {"encode: GOP loop": cuda_ms(lambda: enc(gops), 3),
               "decode: GOP loop": cuda_ms(lambda: dec(planes, mvs), 3)}
    split, lumas = gop_encode_split(enc, gops)
    screened = [sk.count_refined(r, c, ME_BLOCK, SEARCH)[2:]
                for r, c in lumas]
    n_disp = len(lumas) * mvs[:, 0, ..., 0].numel() * (2 * SEARCH + 1) ** 2
    print(f"ipp grid GOP-loop encode split (ms, CUDA events around each "
          f"call): {json.dumps(split)}; SAD screen on the loop's "
          f"references: {sum(c[0] for c in screened)} of {n_disp} "
          f"displacements summed again in float64, "
          f"{sum(c[1] for c in screened)} CTAs a thread an item")
    report = {"rmse": rmse, "rmse_cpu": rmse_cpu,
              "bpp": (2 * int(nw) + side + mv_bytes) * 8 / (n * h * w),
              "cpu_run": f"GOP loop, {cpu_s:.1f} s",
              "mv_blocks_differing_from_cpu": mv_diff / mvs[..., 0].numel(),
              "indexes_differing_from_cpu": idx_diff / d.numel(),
              "encode_ms": enc_ms, "decode_ms": dec_ms, **loop_ms,
              "gb_per_s": clip.nbytes / ((enc_ms + dec_ms) * 1e6)}
    print(f"ipp grid clip {n}x{h}x{w} grans (CUDA events, warm): "
          f"{json.dumps(report)}")
    return launches


def entropy_arrays(codec, cs) -> list:
    """The arrays a stream's entropy stage carries (index planes, label
    maps, pixels): one per DWT subband, else one."""
    from vcf_tpu_torch.codestream import PAYLOAD

    if codec.config.spatial == "dwt":
        out = []
        for name in cs.get_json(PAYLOAD)["subbands"]:
            side = {n.split(".", 1)[1]: cs[n] for n in cs
                    if n.startswith(f"{name}.") and ".q_" not in n}
            out.append(codec.entropy_codec.decode(cs[name], side))
        return out
    side = {n: cs[n] for n in cs
            if n not in (PAYLOAD, "shape", "bopt", "centroids")
            and not n.startswith("q_")}
    return [codec.entropy_codec.decode(cs.payload, side)]


def hold_streams(name: str, rule: str, codec, cs_g, cs_c) -> dict:
    """The card's stream against the CPU's under `rule`; raises past it."""
    same = cs_g.to_bytes() == cs_c.to_bytes()
    if rule == "bytes":
        require(same, f"{name}: the card's stream differs from the CPU's")
        return {"streams_equal": True}
    a_g, a_c = entropy_arrays(codec, cs_g), entropy_arrays(codec, cs_c)
    require([a.shape for a in a_g] == [a.shape for a in a_c],
            f"{name}: stored shapes differ")
    g = np.concatenate([a.reshape(-1).astype(np.int64) for a in a_g])
    c = np.concatenate([a.reshape(-1).astype(np.int64) for a in a_c])
    n_diff = int(np.count_nonzero(g != c))
    if rule == "kmeans":
        agree = 1.0 - n_diff / g.size
        require(agree >= MIN_LABEL_AGREEMENT,
                f"{name}: labels agree on {agree} of entries")
        return {"streams_equal": same, "label_agreement": agree}
    # stored through uint8/uint16 casts that wrap: the distance mod 2^bits
    mod = 1 << (8 * max(a.dtype.itemsize for a in a_g))
    d = (g - c) % mod
    d = np.minimum(d, mod - d)
    require(int(d.max()) <= MAX_INDEX_DIFF
            and n_diff <= MAX_DIFF_SHARE * d.size,
            f"{name}: {n_diff} stored indexes differ, max {int(d.max())}")
    if n_diff == 0:
        for seg in cs_g:
            if ".q_" not in seg and not seg.startswith("q_"):
                require(cs_g[seg] == cs_c[seg],
                        f"{name}: equal indexes, but segment {seg} differs")
    return {"streams_equal": same, "indexes_differ": n_diff,
            "indexes": int(d.size)}


def pixel_rule(a: np.ndarray, b: np.ndarray, what: str) -> int:
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    n = int(np.count_nonzero(d))
    require(d.shape == b.shape and int(d.max()) <= MAX_PIXEL_DIFF
            and n <= MAX_PIXEL_SHARE * d.size,
            f"{what}: {n} pixels differ, max {int(d.max())}")
    return n


def synced_ms(fn):
    """(result, host-clock ms) of one synchronized call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_host_codecs(dev, base: np.ndarray) -> None:
    """4h: the host entropy codecs and the quantizers on phase 4's frame.
    Each configuration encodes on the card and on the CPU in this process,
    holds the two streams to its rule, and decodes both streams on both
    devices (a stream equal to the other decodes once a device); then the
    11 goldens decode on the card, and an 8-frame Lloyd-Max IIICodec clip
    runs with per-frame and with shared levels."""
    from vcf_tpu_torch import Codec, CodecConfig, CodeStream, metrics

    t_phase = time.perf_counter()
    for name, kw, rule, rows in HOST_PHASE:
        img = np.ascontiguousarray(base[:rows] if rows else base)
        cfg = CodecConfig(**kw)
        gpu, cpu = Codec(cfg, device=dev), Codec(cfg, device="cpu")
        gpu.decode(gpu.encode(img[:64]))                 # warm-up
        cs_g, enc_ms = synced_ms(lambda: gpu.encode(img))
        blob = cs_g.to_bytes()
        cs_g = CodeStream.from_bytes(blob)
        t0 = time.perf_counter()
        cs_c = cpu.encode(img)
        cpu_enc_ms = (time.perf_counter() - t0) * 1e3
        held = hold_streams(name, rule, gpu, cs_g, cs_c)
        rec_g, dec_ms = synced_ms(lambda: gpu.decode(cs_g))
        t0 = time.perf_counter()
        rec_c = cpu.decode(cs_g)
        cpu_dec_ms = (time.perf_counter() - t0) * 1e3
        n_px = pixel_rule(rec_g, rec_c, f"{name}: the card's stream")
        if not held["streams_equal"]:
            n_px = max(n_px, pixel_rule(gpu.decode(cs_c), cpu.decode(cs_c),
                                        f"{name}: the CPU's stream"))
        require(rec_g.shape == img.shape and rec_g.dtype == np.uint8,
                f"{name}: decoded {rec_g.shape} {rec_g.dtype}")
        report = {"rows": img.shape[0], "bpp": metrics.bpp(cs_g, img.shape),
                  "rmse": metrics.rmse(img, rec_g), "encode_ms": enc_ms,
                  "decode_ms": dec_ms, "cpu_encode_ms": cpu_enc_ms,
                  "cpu_decode_ms": cpu_dec_ms, "pixels_differ": n_px, **held}
        print(f"host codecs {name}: {json.dumps(report)}")
    golden_decodes(dev)
    for shared in (False, True):
        lloydmax_clip(dev, base, shared)
    print(f"phase 4h: {time.perf_counter() - t_phase:.1f} s")


def golden_decodes(dev) -> None:
    """The 11 golden streams decoded on the card: how many equal their
    stored sha256 (the CPU's), and each against the CPU decode."""
    import hashlib
    from pathlib import Path

    from vcf_tpu_torch import Codec, CodecConfig, CodeStream

    goldens = {
        "dct_default_tiff": dict(), "dct_huffman": dict(entropy="huffman"),
        "dwt_db5_zlib": dict(spatial="dwt", qss=16, dwt_levels=3,
                             entropy="zlib"),
        "ycocg_cbaac": dict(spatial="none", color="ycocg", qss=16,
                            entropy="cbaac"),
        "colorvq_zlib": dict(spatial="none", color="none",
                             quantizer="colorvq", entropy="zlib", seed=1),
        "dwt_sym5_zlib": dict(spatial="dwt", qss=16, dwt_levels=2,
                              wavelet="sym5", entropy="zlib"),
        "dwt_bior44_zlib": dict(spatial="dwt", qss=16, dwt_levels=2,
                                wavelet="bior4.4", entropy="zlib"),
        "dct_lloydmax_zlib": dict(quantizer="lloydmax", qss=32,
                                  entropy="zlib"),
        "dct_grans": dict(entropy="grans"),
        "dwt_grans": dict(spatial="dwt", qss=16, dwt_levels=3,
                          entropy="grans"),
        "dct_cgrans": dict(entropy="cgrans"),
    }
    folder = Path(__file__).resolve().parent / "tests" / "golden"
    equal = []
    for name, kw in sorted(goldens.items()):
        cs = CodeStream.from_file(str(folder / f"{name}.vcft"))
        rec = Codec(CodecConfig(**kw), device=dev).decode(cs)
        rec_cpu = Codec(CodecConfig(**kw), device="cpu").decode(cs)
        pixel_rule(rec, rec_cpu, f"golden {name}")
        want = (folder / f"{name}.sha256").read_text().strip()
        if hashlib.sha256(rec.tobytes()).hexdigest() == want:
            equal.append(name)
    print(f"goldens on the card: {len(equal)} of {len(goldens)} equal their "
          f"stored sha256; the others: "
          f"{sorted(set(goldens) - set(equal))}")


def lloydmax_clip(dev, base: np.ndarray, shared: bool) -> None:
    """The 8-frame Lloyd-Max IIICodec clip (zlib, BatchCodec's Lloyd-Max
    route), per-frame or shared levels, on the card against the CPU."""
    from vcf_tpu_torch import CodecConfig, CodeStream, metrics, video
    from vcf_tpu_torch.config import VideoConfig

    frames = np.stack([np.roll(base, (7 * i, 13 * i), (0, 1))
                       for i in range(FRAMES)])
    cfg = CodecConfig(quantizer="lloydmax", qss=32, entropy="zlib")
    vcfg = VideoConfig(n_frames=FRAMES)
    gpu = video.IIICodec(vcfg, cfg, dev, shared_levels=shared)
    cpu = video.IIICodec(vcfg, cfg, "cpu", shared_levels=shared)
    gpu.decode(gpu.encode(frames[:1, :64]))              # warm-up
    cs_g, enc_ms = synced_ms(lambda: gpu.encode(frames))
    cs_g = CodeStream.from_bytes(cs_g.to_bytes())
    cs_c = cpu.encode(frames)
    levels = gpu._batch.last_qside["levels"]
    require(levels.shape == ((3, 128) if shared else (FRAMES, 3, 128)),
            f"lloydmax clip: levels {levels.shape}")
    require(np.array_equal(levels, cpu._batch.last_qside["levels"]),
            "lloydmax clip: the card's levels differ from the CPU's")
    require(cs_g.to_bytes() == cs_c.to_bytes(),
            "lloydmax clip: the card's stream differs from the CPU's")
    rec, dec_ms = synced_ms(lambda: gpu.decode(cs_g))
    n_px = pixel_rule(rec, cpu.decode(cs_g), "lloydmax clip")
    report = {"shared_levels": shared, "bpp": metrics.bpp(cs_g, frames.shape),
              "rmse": metrics.rmse(frames, rec), "encode_ms": enc_ms,
              "decode_ms": dec_ms, "pixels_differ": n_px}
    print(f"lloydmax clip {FRAMES}x{H}x{W}: {json.dumps(report)}")


def flow_weights_rule(name: str, cs_g, cs_c, frame: np.ndarray, cfg) -> dict:
    """The "trained" rule's weights: KLT's rows whose eigenvalue stands
    apart from its neighbours (gap >= KLT_SEPARATED of the channel's
    largest, from the CPU's float64 covariance) within KLT_ROW_TOL up to
    sign, every other row reported (ROADMAP C3: near-equal eigenvalues
    make their eigenvectors arbitrary); LBT's decoder weights and block
    mean within LBT_WEIGHT_TOL."""
    from vcf_tpu_torch.ops import color as color_ops
    from vcf_tpu_torch.ops import dct as dct_ops
    from vcf_tpu_torch.ops import klt

    w_g = torch.from_numpy(cs_g.get_array("weights")).double()
    w_c = torch.from_numpy(cs_c.get_array("weights")).double()
    require(w_g.shape == w_c.shape, f"{name}: weights {tuple(w_g.shape)} vs "
            f"{tuple(w_c.shape)}")
    if cfg.spatial == "lbt":
        gap = float((w_g - w_c).abs().max())
        mean_gap = float(np.abs(cs_g.get_array("mean").astype(np.float64)
                                - cs_c.get_array("mean")).max())
        require(gap <= LBT_WEIGHT_TOL and mean_gap <= LBT_WEIGHT_TOL,
                f"{name}: decoder weights differ by {gap}, mean by "
                f"{mean_gap}")
        return {"weight_gap": gap, "mean_gap": mean_gap}
    # the blocks the KLT trains on, in float64
    x = torch.from_numpy(frame).double()
    padded = dct_ops.pad_centered(x, cfg.block_size) - (
        128.0 if cfg.quantizer == "deadzone" else 0.0)
    m = torch.from_numpy(color_ops.MATRICES[cfg.color][0]).double()
    blocks = klt.channel_blocks(padded @ m.T, cfg.block_size)
    c = blocks - blocks.mean(1, keepdim=True)
    ev = torch.linalg.eigvalsh(
        torch.einsum("cnd,cne->cde", c, c) / c.shape[1]).flip(-1)
    gap = torch.full_like(ev, float("inf"))
    gap[:, :-1] = torch.minimum(gap[:, :-1], ev[:, :-1] - ev[:, 1:])
    gap[:, 1:] = torch.minimum(gap[:, 1:], ev[:, :-1] - ev[:, 1:])
    apart = gap / ev[:, :1] >= KLT_SEPARATED
    d = torch.minimum((w_g - w_c).abs().amax(2), (w_g + w_c).abs().amax(2))
    sep_gap = float(d[apart].max())
    require(sep_gap <= KLT_ROW_TOL,
            f"{name}: {int(apart.sum())} separated rows differ by {sep_gap}")
    return {"separated_rows": int(apart.sum()), "rows": int(d.numel()),
            "separated_row_gap": sep_gap, "weight_gap": float(d.max()),
            "rows_over_1e-3": int((d > 1e-3).sum())}


def near(a: float, b: float, rtol: float) -> bool:
    return abs(a - b) <= rtol * max(abs(a), abs(b))


def bm3d_stage_shares(dev, part: np.ndarray, sigma: float = 25.0) -> dict:
    """ROADMAP C13: BM3D's steps on the card against the CPU on one u8
    frame (H, W % 8 == 0), phase (0, 0) of each stage, each step fed the
    CPU's input to it: the share of elements that differ (bitwise) at the
    luma, the block distances, the group selection (blocks; also from the
    card's own distances: the cascade), the 2-D and 3-D coefficients, the
    stage-1 keep mask at 2.7 sigma, the stage-2 Wiener spectrum and block
    weights, and each stage's whole estimate (float, and u8 after the round;
    stage 2 guided by the CPU's stage-1 estimate on both devices)."""
    from vcf_tpu_torch.ops import color as color_ops
    from vcf_tpu_torch.ops import dct as dct_ops
    from vcf_tpu_torch.ops import filters

    b, n_group, s = 8, 8, 8
    x = torch.from_numpy(part).to(torch.float32)
    h, w, c = x.shape
    disps = filters.displacements(s)
    disp_t = torch.from_numpy(disps)
    d1 = torch.from_numpy(dct_ops.dct_matrix(n_group))
    rows, cols = torch.arange(h)[:, None], torch.arange(w)[None, :]

    def share(g: torch.Tensor, ref: torch.Tensor) -> float:
        return float((g.cpu() != ref).double().mean())

    def on(dv, fn, *args):
        return fn(*[a.to(dv) if torch.is_tensor(a) else a for a in args])

    def coeffs(img, sel):
        dsel = disp_t.to(sel.device)[sel]
        dy = filters._px(dsel[..., 0], b)
        dx = filters._px(dsel[..., 1], b)
        r, q = rows.to(sel.device), cols.to(sel.device)
        src = torch.remainder(r + dy, h) * w + torch.remainder(q + dx, w)
        grp = torch.stack([img.reshape(-1, c)[i] for i in src])
        c2 = dct_ops.analyze(grp, b)
        return c2, torch.einsum("mn,nhwc->mhwc", d1.to(sel.device), c2)

    def u8(t):
        return torch.clamp(torch.round(t), 0, 255).to(torch.int64).cpu()

    def luma(g):
        return color_ops.fma_rows(g, filters.LUMA_WEIGHTS[None]).squeeze(-1)

    def dist(lm):
        return filters.block_distances(lm, disps, b)

    out, guide_c = {}, x
    for stage in ("hard", "wiener"):
        luma_c = luma(guide_c)
        out[f"{stage}.luma"] = share(on(dev, luma, guide_c), luma_c)
        dv_c = dist(luma_c)
        dv_g = on(dev, dist, luma_c)
        out[f"{stage}.distances"] = share(dv_g, dv_c)
        sel_c = filters.select_group(dv_c, n_group)
        out[f"{stage}.selection"] = float(
            (on(dev, filters.select_group, dv_c, n_group).cpu() != sel_c)
            .any(0).double().mean())
        out[f"{stage}.selection_cascade"] = float(
            (filters.select_group(dv_g, n_group).cpu() != sel_c)
            .any(0).double().mean())
        c2_c, c3_c = coeffs(x, sel_c)
        c2_g, c3_g = coeffs(x.to(dev), sel_c.to(dev))
        out[f"{stage}.coeff2"] = share(c2_g, c2_c)
        out[f"{stage}.coeff3"] = share(c3_g, c3_c)
        out[f"{stage}.coeff3_max_abs"] = float((c3_g.cpu() - c3_c).abs().max())
        if stage == "hard":
            thresh = 2.7 * sigma
            out["hard.keep"] = share(c3_g.abs() >= thresh, c3_c.abs() >= thresh)
            est = lambda xx: filters._bm3d_stage(xx, xx, sigma, b, n_group, s,
                                                 2, wiener=False)
            est_c, est_g = est(x), on(dev, est, x)
        else:
            _, cg3_c = coeffs(guide_c, sel_c)
            wsh_c, wgt_c = filters.wiener_weights(cg3_c, sigma, b)
            wsh_g, wgt_g = filters.wiener_weights(cg3_c.to(dev), sigma, b)
            out["wiener.spectrum"] = share(wsh_g, wsh_c)
            out["wiener.weight"] = share(wgt_g, wgt_c)
            est = lambda xx, gg: filters._bm3d_stage(xx, gg, sigma, b, n_group,
                                                     s, 2, wiener=True)
            est_c, est_g = est(x, guide_c), on(dev, est, x, guide_c)
        out[f"{stage}.estimate"] = share(est_g, est_c)
        d = (u8(est_g) - u8(est_c)).abs()
        out[f"{stage}.estimate_u8"] = float((d != 0).double().mean())
        out[f"{stage}.estimate_u8_max"] = int(d.max())
        guide_c = est_c
    return out


def flow_case(dev, name: str, kw: dict, rule: str, crop, base: np.ndarray,
              kernels: dict) -> dict:
    """One configuration of 4i on the full frame on the card, against the
    port's CPU run; -> the launches of the card's encode and decode."""
    from vcf_tpu_torch import Codec, CodecConfig, CodeStream, metrics
    from vcf_tpu_torch.ops import filters

    cfg = CodecConfig(**kw)
    gpu, cpu = Codec(cfg, device=dev), Codec(cfg, device="cpu")
    gpu.decode(gpu.encode(base[:64]))                    # warm-up
    zero_counts(kernels)
    cs_g, enc_ms = synced_ms(lambda: gpu.encode(base))
    cs_g = CodeStream.from_bytes(cs_g.to_bytes())
    rec_g, dec_ms = synced_ms(lambda: gpu.decode(cs_g))
    launches = {k: fn.launches for k, fn in kernels.items()}
    require(rec_g.shape == base.shape and rec_g.dtype == np.uint8,
            f"{name}: decoded {rec_g.shape} {rec_g.dtype}")
    report = {"bpp": metrics.bpp(cs_g, base.shape),
              "rmse": metrics.rmse(base, rec_g), "encode_ms": enc_ms,
              "decode_ms": dec_ms}
    if rule == "trained" and crop is not None:
        # the CPU trains on a crop; the card trains on it too, to compare
        img = np.ascontiguousarray(base[:crop[0], :crop[1]])
        report["cpu_crop"] = list(crop)
        pixel_rule(cpu.decode(cs_g), rec_g, f"{name}: the card's frame on "
                   "the CPU")
        cs_gc = CodeStream.from_bytes(gpu.encode(img).to_bytes())
    else:
        img, cs_gc = base, cs_g
    t0 = time.perf_counter()
    cs_c = cpu.encode(img)
    report["cpu_encode_ms"] = (time.perf_counter() - t0) * 1e3
    if rule == "trained":
        report.update(flow_weights_rule(name, cs_gc, cs_c, img, cfg))
        rec_gc = gpu.decode(cs_gc)
        t0 = time.perf_counter()
        rec_cc = cpu.decode(cs_c)
        report["cpu_decode_ms"] = (time.perf_counter() - t0) * 1e3
        n_px = pixel_rule(cpu.decode(cs_gc), rec_gc, f"{name}: the card's "
                          "stream")
        n_px += pixel_rule(gpu.decode(cs_c), rec_cc, f"{name}: the CPU's "
                           "stream")
        bpp = (metrics.bpp(cs_gc, img.shape), metrics.bpp(cs_c, img.shape))
        rmse = (metrics.rmse(img, rec_gc), metrics.rmse(img, rec_cc))
        require(near(*bpp, TRAINED_RTOL) and near(*rmse, TRAINED_RTOL),
                f"{name}: bpp {bpp}, rmse {rmse} (card, CPU)")
        report.update({"streams_equal": cs_gc.to_bytes() == cs_c.to_bytes(),
                       "bpp_card_cpu": bpp, "rmse_card_cpu": rmse,
                       "pixels_differ": n_px})
        return report, launches
    report.update(hold_streams(name, "index", gpu, cs_g, cs_c))
    if cfg.filter == "none":
        t0 = time.perf_counter()
        rec_c = cpu.decode(cs_g)
        report["cpu_decode_ms"] = (time.perf_counter() - t0) * 1e3
        report["pixels_differ"] = pixel_rule(rec_g, rec_c, f"{name}: the "
                                             "card's stream")
        if not report["streams_equal"]:
            report["pixels_differ"] += pixel_rule(
                gpu.decode(cs_c), cpu.decode(cs_c), f"{name}: the CPU's "
                "stream")
        return report, launches
    # the filter rule: the unfiltered frame decodes alike on both devices,
    # and the filter on the card against the CPU's, on the crop
    plain = CodecConfig(**{**kw, "filter": "none"})
    unf = Codec(plain, device=dev).decode(cs_g)
    n_px = pixel_rule(unf, Codec(plain, device="cpu").decode(cs_g),
                      f"{name}: the unfiltered frame")
    part = np.ascontiguousarray(unf[:crop[0], :crop[1]] if crop else unf)
    out_g = filters.get(cfg, dev)(part)
    t0 = time.perf_counter()
    out_c = filters.get(cfg, "cpu")(part)
    report["cpu_filter_ms"] = (time.perf_counter() - t0) * 1e3
    d = np.abs(out_g.astype(np.int64) - out_c)
    n_over = int(np.count_nonzero(d > 1))
    require(int(d.max()) <= FILTER_MAX_DIFF and n_over <= FILTER_SHARE * d.size,
            f"{name}: the card's filter against the CPU's: max {int(d.max())}, "
            f"{n_over} pixels past 1")
    if cfg.filter == "bm3d":
        require(n_over == 0 and np.count_nonzero(d) <= BM3D_SHARE * d.size,
                f"{name}: C13's rule: {np.count_nonzero(d)} pixels differ, "
                f"{n_over} past 1")
        report["bm3d_stages"] = bm3d_stage_shares(dev, part)
    require(np.array_equal(filters.get(cfg, dev)(unf), rec_g),
            f"{name}: the decode is not the filtered frame")
    report.update({"filter_rows": part.shape[0], "filter_cols": part.shape[1],
                   "filter_pixels_differ": int(np.count_nonzero(d)),
                   "filter_pixels_past_1": n_over,
                   "filter_max_diff": int(d.max()),
                   "unfiltered_pixels_differ": n_px})
    return report, launches


def ipp_generic_case(dev, clip: np.ndarray, kernels: dict) -> dict:
    """4i's IPP row: the generic closed loop over 4 frames of the 4c clip
    with the DWT grans still codec, on the card against the CPU under
    C7's rule; -> its launches."""
    from vcf_tpu_torch import CodecConfig, CodeStream, metrics, video
    from vcf_tpu_torch.config import VideoConfig
    from vcf_tpu_torch.entropy import dwt_device as dd

    frames = clip[:GENERIC_FRAMES]
    vcfg = VideoConfig(mode="ipp", n_frames=GENERIC_FRAMES, gop_size=GOP,
                       me_block=ME_BLOCK, search_range=SEARCH)
    ccfg = CodecConfig(spatial="dwt", entropy="grans")
    ipp = video.get(vcfg, ccfg, dev)
    require(not ipp.fused and ipp._make_search(H, W).kind == "sad_search",
            "IPP generic: not the generic loop with the SAD kernel")
    ipp.decode(ipp.encode(frames[:2, :64]))              # warm-up
    zero_counts(kernels)
    cs, enc_ms = synced_ms(lambda: ipp.encode(frames))
    cs = CodeStream.from_bytes(cs.to_bytes())
    rec, dec_ms = synced_ms(lambda: ipp.decode(cs))
    launches = {k: fn.launches for k, fn in kernels.items()}
    print(f"ipp generic path: launches {launches}")
    for k, count in launches.items():
        require(count > 0, f"kernel {k} was not launched on the generic "
                "IPP path")
    require_ipp_modes("IPP generic path")
    require(np.array_equal(rec, ipp.last_recon.cpu().numpy()),
            "IPP generic: the decoder differs from the encoder's loop")
    cpu = video.get(vcfg, ccfg, "cpu")
    t0 = time.perf_counter()
    cs_c = cpu.encode(frames)
    cpu_s = time.perf_counter() - t0
    require(list(cs) == list(cs_c), "IPP generic: other segments")
    mv_names = [k for k in cs if k.startswith("mv_")]
    mv_diff = sum(int((cs.get_array(k) != cs_c.get_array(k)).any(-1).sum())
                  for k in mv_names)
    # C7's rule on the frames' lane grids, decoded on the card
    idx_diff = n_idx = 0
    for i in range(GENERIC_FRAMES):
        grids = []
        for s in (cs, cs_c):
            g, sg, l, n_words, _, st, cnt, fg, cg, _ = dd.unpack_model(
                s[f"f{i:04d}.gdwt_model"])
            words = np.frombuffer(s[f"f{i:04d}.gdwt_words"], "<u2")[:n_words]
            grids.append(dd.decode_grid(words, st, cnt, fg, cg, l, dev))
        d = (grids[0].to(torch.int64) - grids[1].to(torch.int64)).abs()
        require(bool(((d <= MAX_INDEX_DIFF) | (d == 255)).all()),
                f"IPP generic frame {i}: a grid index moved by more than 1")
        idx_diff += int((d != 0).sum())
        n_idx += d.numel()
    require(idx_diff <= MAX_IPP_DIFF_SHARE * n_idx,
            f"IPP generic: {idx_diff} grid indexes differ from the CPU")
    same = cs.to_bytes() == cs_c.to_bytes()
    if mv_diff == 0 and idx_diff == 0:
        require(same, "IPP generic: equal mvs and indexes, other streams")
    rec_cpu = cpu.last_recon.to(torch.uint8).numpy()
    rmse, rmse_cpu = metrics.rmse(frames, rec), metrics.rmse(frames, rec_cpu)
    require(abs(rmse - rmse_cpu) <= MAX_IPP_RMSE_DIFF,
            f"IPP generic rmse {rmse} vs CPU {rmse_cpu}")
    if not same:
        pixel_rule(ipp.decode(cs_c), cpu.decode(cs_c), "IPP generic: the "
                   "CPU's stream")
    report = {"rmse": rmse, "rmse_cpu": rmse_cpu,
              "bpp": metrics.bpp(cs, frames.shape), "encode_ms": enc_ms,
              "decode_ms": dec_ms, "cpu_encode_ms": cpu_s * 1e3,
              "mv_blocks_differing_from_cpu": mv_diff,
              "grid_indexes_differing_from_cpu": idx_diff,
              "streams_equal": same}
    print(f"codec compositions ipp_generic {GENERIC_FRAMES}x{H}x{W} dwt "
          f"grans: {json.dumps(report)}")
    return launches


def phase_compositions(dev, base: np.ndarray, clip: np.ndarray) -> dict:
    """4i: the compositions of the last slice at 1088x1920 on the card
    (KLT, MDCT and LBT, `srans`, `ihuff`, the three decode filters, and
    the generic IPP loop), each against the port's CPU run.  The card
    always runs the full frame; the CPU references of LBT's training and
    of the NLM and BM3D filters run on crops of it (LBT_CROP, NLM_CROP,
    BM3D_CROP): LBT trains on the crop on both devices, the filters run
    on the crop of the card's unfiltered decode on both.  -> the launches
    of K1-K3 (dct_srans and the IPP loop's DWT grans still codec) and of
    SAD and MC (the IPP loop), summed."""
    from vcf_tpu_torch.ops.cuda import mc_kernel as mk
    from vcf_tpu_torch.ops.cuda import rans_decode as rd
    from vcf_tpu_torch.ops.cuda import rans_encode as re_
    from vcf_tpu_torch.ops.cuda import sad_kernel as sk

    rans_k = {"rans_encode_grouped": re_.rans_encode_grouped,
              "rans_compact": re_.rans_compact,
              "rans_decode_grouped": rd.rans_decode_grouped}
    t_phase = time.perf_counter()
    total: dict = {}
    for name, kw, rule, crop in FLOW_PHASE:
        report, launches = flow_case(dev, name, kw, rule, crop, base, rans_k)
        if name == "dct_srans":
            for k, count in launches.items():
                require(count > 0, f"kernel {k} was not launched by srans")
            for k, count in launches.items():
                total[k] = total.get(k, 0) + count
            report["launches"] = launches
        print(f"codec compositions {name}: {json.dumps(report)}")
    ipp_k = {**rans_k, "sad_search": sk.sad_search,
             "mc_apply_planar": mk.mc_apply_planar}
    for k, count in ipp_generic_case(dev, clip, ipp_k).items():
        total[k] = total.get(k, 0) + count
    print(f"phase 4i: {time.perf_counter() - t_phase:.1f} s")
    return total


def cli_run(kernels: dict, argv: list, expect=()) -> dict:
    """One in-process `vcf_tpu_torch.cli.main(argv)` with the launch counts
    of `kernels` set to 0 before it; -> its launches (each of `expect`
    must be > 0)."""
    from vcf_tpu_torch import cli

    zero_counts(kernels)
    require(cli.main(argv) == 0, f"cli {' '.join(argv[:1])} failed")
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernels.items()}
    for k in expect:
        require(launches[k] > 0, f"kernel {k} was not launched by the CLI "
                f"({' '.join(argv)})")
    return launches


def file_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


# the subprocess of 4j: `python -m vcf_tpu_torch` through runpy, then the
# probe of tests/test_torch_cli.py on what it imported
MODULE_PROBE = """
import runpy, sys
sys.argv = ["vcf_tpu_torch"] + sys.argv[1:]
try:
    runpy.run_module("vcf_tpu_torch", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
assert "jax" not in sys.modules, "jax imported"
assert "vcf_tpu" not in sys.modules, "vcf_tpu imported"
"""


def phase_entry_points(dev, base: np.ndarray, clip: np.ndarray,
                       ipp_run: tuple) -> dict:
    """4j: the entry points on the card at full width.  `vcf_tpu_torch.cli
    .main` in this process with no --device (so on the card): encode,
    decode and rde of phase 4's frame with `grans` and encode/decode with
    DWT `cgrans`, each file equal to the in-process Codec's stream and
    decode; video-encode/decode of the 4c clip as a Y4M with III `grans`
    and with 4c's IPP configuration, each stream equal to the in-process
    clip codec's (IPP: 4c's own stream and decode, `ipp_run`), the III
    decode with --preview too; the IPP decode inside
    `utils.profiling.trace`; then `python -m vcf_tpu_torch encode` as a
    subprocess with no --device, its file equal to this process's, no jax
    or vcf_tpu imported.  -> the CLI's launches, summed."""
    import contextlib
    import io
    import tempfile

    from vcf_tpu_torch import Codec, CodecConfig, CodeStream, cli, video
    from vcf_tpu_torch.config import VideoConfig
    from vcf_tpu_torch.io import read_image, write_image
    from vcf_tpu_torch.io.video import read_y4m, write_y4m
    from vcf_tpu_torch.ops.cuda import dct_kernel as dk
    from vcf_tpu_torch.ops.cuda import mc_kernel as mk
    from vcf_tpu_torch.ops.cuda import rans_ctx as rc
    from vcf_tpu_torch.ops.cuda import rans_decode as rd
    from vcf_tpu_torch.ops.cuda import rans_encode as re_
    from vcf_tpu_torch.ops.cuda import sad_kernel as sk
    from vcf_tpu_torch.utils import profiling

    kernels = {"rans_encode_grouped": re_.rans_encode_grouped,
               "rans_compact": re_.rans_compact,
               "rans_decode_grouped": rd.rans_decode_grouped,
               "rans_encode_ctx": rc.rans_encode_ctx,
               "rans_decode_ctx": rc.rans_decode_ctx,
               "fused_dct_quantize": dk.fused_dct_quantize,
               "fused_dequantize_idct": dk.fused_dequantize_idct,
               "fused_cdct_quantize": dk.fused_cdct_quantize,
               "fused_dequantize_cdct": dk.fused_dequantize_cdct,
               "sad_search": sk.sad_search,
               "mc_apply_planar": mk.mc_apply_planar}
    k_enc = ("rans_encode_grouped", "rans_compact")
    k_dec = ("rans_decode_grouped",)
    t_phase = time.perf_counter()
    total: dict = {}
    report: dict = {}

    def add(launches):
        for k, count in launches.items():
            total[k] = total.get(k, 0) + count

    with tempfile.TemporaryDirectory(prefix="vcf_cli_") as d:
        png, y4m = os.path.join(d, "base.png"), os.path.join(d, "clip.y4m")
        write_image(png, base)
        write_y4m(y4m, clip)
        require(np.array_equal(read_y4m(y4m), clip), "the Y4M clip differs")

        # still images
        for name, flags, cfg, expect in (
                ("grans", ["-c", "grans"], CodecConfig(entropy="grans"),
                 (k_enc, k_dec)),
                ("dwt_cgrans", ["-T", "2D-DWT", "-c", "cgrans"],
                 CodecConfig(spatial="dwt", entropy="cgrans"),
                 (("rans_encode_ctx", "rans_compact"), ("rans_decode_ctx",)))):
            enc, dec = os.path.join(d, name), os.path.join(d, f"dec_{name}.png")
            add(cli_run(kernels, ["encode", "-o", png, "-e", enc] + flags,
                        expect[0]))
            add(cli_run(kernels, ["decode", "-e", enc, "-d", dec] + flags,
                        expect[1]))
            codec = Codec(cfg, device=dev)
            blob = codec.encode(base).to_bytes()
            require(file_bytes(enc) == blob, f"4j {name}: the CLI's file "
                    "differs from the in-process stream")
            require(np.array_equal(read_image(dec),
                                   codec.decode(CodeStream.from_bytes(blob))),
                    f"4j {name}: the CLI's PNG differs from the in-process "
                    "decode")
            report[f"{name}_bytes"] = len(blob)
            if name == "grans":
                out = io.StringIO()
                with contextlib.redirect_stdout(out):
                    require(cli.main(["rde", "-o", png, "-e", enc, "-d", dec])
                            == 0, "4j rde failed")
                report["rde_grans"] = json.loads(out.getvalue().strip())
                print(f"entry points rde grans: {out.getvalue().strip()}")
                grans_file = enc

        # video: III grans (encoded in process here), IPP as phase 4c
        ipp_blob, ipp_rec = ipp_run
        n = str(len(clip))
        for name, flags, ref in (
                ("iii", ["-T", "III", "-c", "grans", "-N", n], None),
                ("ipp", ["-T", "IPP", "-c", "grans", "-x", "-N", n, "-G",
                         str(GOP), "-M", str(ME_BLOCK), "-S", str(SEARCH)],
                 (ipp_blob, ipp_rec))):
            enc, dec = os.path.join(d, name), os.path.join(d, f"dec_{name}.y4m")
            if name == "iii":
                expect = (("fused_cdct_quantize",) + k_enc,
                          ("fused_dequantize_cdct",) + k_dec)
                iii = video.get(VideoConfig(mode="iii", n_frames=len(clip)),
                                CodecConfig(entropy="grans"), dev)
                blob = iii.encode(clip).to_bytes()
                ref = (blob, iii.decode(CodeStream.from_bytes(blob)))
            else:
                expect = (("sad_search", "mc_apply_planar", "fused_dct_quantize",
                           "fused_dequantize_idct") + k_enc,
                          ("mc_apply_planar", "fused_dequantize_idct") + k_dec)
            add(cli_run(kernels, ["video-encode", "-o", y4m, "-e", enc] + flags,
                        expect[0]))
            if name == "ipp":
                require_ipp_modes("4j IPP encode")
                trace_dir = os.path.join(d, "trace")
                torch.cuda.reset_peak_memory_stats()
                with profiling.trace(trace_dir):
                    add(cli_run(kernels, ["video-decode", "-e", enc, "-d", dec]
                                + flags, expect[1]))
                trace = os.path.join(trace_dir, "trace.json")
                peak = max(s["allocated_bytes.all.peak"]
                           for s in profiling.device_memory_stats().values())
                report["ipp_decode_trace_bytes"] = os.path.getsize(trace)
                report["peak_allocated_bytes"] = peak
                print(f"entry points profiler: the IPP CLI decode's trace "
                      f"{os.path.getsize(trace)} bytes, its peak allocated "
                      f"{peak} bytes")
            else:
                prefix = os.path.join(d, "preview")
                add(cli_run(kernels, ["video-decode", "-e", enc, "-d", dec,
                                      "--preview", prefix] + flags, expect[1]))
                for i in range(len(clip)):
                    require(np.array_equal(read_image(f"{prefix}_{i:04d}.png"),
                                           ref[1][i]),
                            f"4j preview frame {i} differs from the decode")
                require(os.path.exists(prefix + ".y4m")
                        or os.path.exists(prefix + ".mp4"),
                        "4j --preview wrote no preview clip")
            require(file_bytes(enc) == ref[0], f"4j {name}: the CLI's stream "
                    "differs from the in-process stream")
            require(np.array_equal(read_y4m(dec), ref[1]), f"4j {name}: the "
                    "CLI's Y4M differs from the in-process decode")
            report[f"{name}_bytes"] = len(ref[0])

        # the module entry point in a fresh process, default device
        out = os.path.join(d, "module_grans")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", MODULE_PROBE, "encode", "-o", png, "-e",
             out, "-c", "grans"], cwd=os.path.dirname(os.path.abspath(
                 __file__)), capture_output=True, text=True, timeout=300)
        report["module_s"] = time.perf_counter() - t0
        require(proc.returncode == 0, f"python -m vcf_tpu_torch: {proc.stderr}")
        require(file_bytes(out) == file_bytes(grans_file),
                "python -m vcf_tpu_torch wrote another stream")
    report["launches"] = total
    report["seconds"] = time.perf_counter() - t_phase
    print(f"entry points: {json.dumps(report)}")
    print(f"phase 4j: {report['seconds']:.1f} s")
    return total


# phase 4k (distribution): the in-process meshes' shard counts, the
# wavelets of the row-sharded DWT, the tolerances of the sharded k-means
# (centres; labels by agreement) and of LBT's step, the seeded noise on
# the DCT basis where LBT's step starts (at the basis itself the decoder's
# MSE gradient is rounding noise, whose sign Adam's first step turns into
# a full step), and the two Gloo workers' time limit
DIST_SHARDS, IPP_SHARDS = 4, 2
DIST_WAVELETS = ("haar", "db5", "bior4.4")
KMEANS_CENTRE_ATOL = 1e-3
LBT_RTOL, LBT_INIT_NOISE = 1e-5, 1e-2
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "_torch_dist_worker.py")
WORKER_TIMEOUT_S = 300


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_workers(port: int) -> list:
    """The two Gloo ranks of tests/_torch_dist_worker.py, each coding on
    cuda:0 at full width (NCCL refuses two ranks on one card)."""
    return [subprocess.Popen(
        [sys.executable, WORKER, f"127.0.0.1:{port}", "2", str(rank), "cuda",
         str(H), str(W)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(2)]


def stop_workers(procs: list) -> None:
    """Kill any worker still running (after a failure or a timeout)."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


def finish_workers(procs: list) -> dict:
    """Wait for the workers (bounded); any failure or timeout raises, and
    no worker outlives the call.  -> rank 0's report."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            outs.append((p.returncode, out, err))
    finally:
        stop_workers(procs)
    for rank, (rc, _, err) in enumerate(outs):
        require(rc == 0, f"gloo worker {rank} failed (rc {rc}):\n"
                f"{err[-3000:]}")
    lines = [ln for ln in outs[0][1].splitlines() if ln.startswith("{")]
    require(bool(lines), "gloo worker 0 printed no report")
    return json.loads(lines[-1])


def sha256(blob: bytes) -> str:
    import hashlib

    return hashlib.sha256(blob).hexdigest()


def phase_distribution(dev, base: np.ndarray, frames: np.ndarray,
                       clip: np.ndarray, iii_run: tuple, ipp_run: tuple
                       ) -> dict:
    """4k: the distribution layer on the card.  In-process meshes on
    cuda:0 (their shards run one after another there): the 8-frame `grans`
    IIICodec clip on 4 shards (stream equal to 4b's, B3/B4 and K1-K3
    launched, once a shard for the transforms), timed in turns against the
    one-device clip; the shared-levels Lloyd-Max BatchCodec on 4 shards
    (levels and planes equal to one device's); 4c's IPP clip on 2 shards
    (stream and decode equal to 4c's, SAD's m=16 instance and MC's vector
    mode); the row-sharded DWT level of phase 4's frame in 4 slabs of 272
    rows (haar, db5, bior4.4; bit for bit `analyze_level`); the sharded
    k-means on 4h's DCT + `vq` blocks against `kmeans` from the same init;
    one LBT step over 4 shards of the frame's blocks against the same step
    on the CPU.  Then `torch.distributed`: a world of one over NCCL
    (`allreduce_histogram` and `replicate` through NCCL, and the
    shared-levels BatchCodec on a 4-shard mesh with that group, equal to
    the in-process results), and two Gloo worker processes, each coding on
    cuda:0 (streams gathered in frame order, equal to this process's
    encodes; shared Lloyd-Max levels and planes equal to one process's).
    -> the in-process paths' launches, summed."""
    import torch.distributed as tdist

    from vcf_tpu_torch import Codec, CodecConfig, CodeStream, video
    from vcf_tpu_torch.config import VideoConfig
    from vcf_tpu_torch.ops import dct as dct_ops
    from vcf_tpu_torch.ops import dwt, lbt, prng, vq
    from vcf_tpu_torch.ops.cuda import dct_kernel as dk
    from vcf_tpu_torch.ops.cuda import mc_kernel as mk
    from vcf_tpu_torch.ops.cuda import rans_decode as rd
    from vcf_tpu_torch.ops.cuda import rans_encode as re_
    from vcf_tpu_torch.ops.cuda import sad_kernel as sk
    from vcf_tpu_torch.parallel import BatchCodec, Mesh, dist, make_mesh

    t_phase = time.perf_counter()
    kernels = {"rans_encode_grouped": re_.rans_encode_grouped,
               "rans_compact": re_.rans_compact,
               "rans_decode_grouped": rd.rans_decode_grouped,
               "fused_dct_quantize": dk.fused_dct_quantize,
               "fused_dequantize_idct": dk.fused_dequantize_idct,
               "fused_cdct_quantize": dk.fused_cdct_quantize,
               "fused_dequantize_cdct": dk.fused_dequantize_cdct,
               "sad_search": sk.sad_search,
               "mc_apply_planar": mk.mc_apply_planar}
    total: dict = {}

    def count(what: str, required) -> dict:
        launches = {name: fn.launches for name, fn in kernels.items()}
        print(f"distribution {what}: launches {launches}")
        for name in required:
            require(launches[name] > 0,
                    f"kernel {name} was not launched on the {what} path")
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        return launches

    report = {"device_count": torch.cuda.device_count(),
              "make_mesh_size": make_mesh().size}
    print(f"distribution: {torch.cuda.device_count()} card(s) visible, "
          f"make_mesh() has {report['make_mesh_size']} device(s)")
    mesh = Mesh((dev,) * DIST_SHARDS)

    # the III clip on 4 shards against 4b's one-device stream
    iii_rec, iii_blob = iii_run
    vcfg, ccfg = VideoConfig(n_frames=FRAMES), CodecConfig(entropy="grans")
    sharded = video.IIICodec(vcfg, ccfg, dev, mesh=mesh)
    zero_counts(kernels)
    blob = sharded.encode(frames).to_bytes()
    rec = sharded.decode(CodeStream.from_bytes(blob))
    torch.cuda.synchronize()
    launches = count("III clip on 4 shards",
                     ("rans_encode_grouped", "rans_compact",
                      "rans_decode_grouped", "fused_cdct_quantize",
                      "fused_dequantize_cdct"))
    require(launches["fused_cdct_quantize"] == DIST_SHARDS
            and launches["fused_dequantize_cdct"] == DIST_SHARDS,
            "the sharded clip's transforms did not launch once a shard")
    require(blob == iii_blob, "the 4-shard clip's stream differs from 4b's")
    require(np.array_equal(rec, iii_rec),
            "the 4-shard clip's decode differs from 4b's")
    one = video.IIICodec(vcfg, ccfg, dev)
    turns = {"one device": [], "4 shards": []}
    for name, codec in (("one device", one), ("4 shards", sharded),
                        ("4 shards", sharded), ("one device", one)):
        cs, enc_ms = synced_ms(lambda: codec.encode(frames))
        _, dec_ms = synced_ms(lambda: codec.decode(cs))
        turns[name].append([enc_ms, dec_ms])
    report["iii_clip_ms_in_turns"] = turns
    # the Gloo workers run beside the rest of the phase (phase 2 built the
    # kernel library, so they only load it)
    procs = start_workers(free_port())
    try:
        # shared Lloyd-Max levels on 4 shards
        lm_cfg = CodecConfig(quantizer="lloydmax", qss=32, entropy="zlib")
        lm_one = BatchCodec(lm_cfg, dev, shared_levels=True)
        lm_planes = lm_one.encode_planes(frames)
        lm_levels = lm_one.last_qside["levels"]
        lm = BatchCodec(lm_cfg, dev, mesh=mesh, shared_levels=True)
        require(np.array_equal(lm.encode_planes(frames), lm_planes)
                and np.array_equal(lm.last_qside["levels"], lm_levels),
                "the 4-shard shared Lloyd-Max levels or planes differ")

        # 4c's IPP clip on 2 shards
        ipp_blob, ipp_rec = ipp_run
        ipp = video.IPPCodec(
            VideoConfig(mode="ipp", n_frames=len(clip), gop_size=GOP,
                        me_block=ME_BLOCK, search_range=SEARCH),
            CodecConfig(entropy="grans", subbands=False), dev,
            mesh=Mesh((dev,) * IPP_SHARDS))
        zero_counts(kernels)
        blob = ipp.encode(clip).to_bytes()
        rec = ipp.decode(CodeStream.from_bytes(blob))
        torch.cuda.synchronize()
        count("IPP clip on 2 shards", ("sad_search", "mc_apply_planar",
                                       "fused_dct_quantize",
                                       "fused_dequantize_idct"))
        require_ipp_modes("the 2-shard IPP path")
        require(blob == ipp_blob, "the 2-shard IPP stream differs from 4c's")
        require(np.array_equal(rec, ipp_rec),
                "the 2-shard IPP decode differs from 4c's")

        # the row-sharded DWT level
        x = torch.from_numpy(base.astype(np.float32)).to(dev) - 128.0
        slabs = list(x.chunk(DIST_SHARDS))
        for name in DIST_WAVELETS:
            bank = dwt.get_bank(name)
            ll, det = dwt.analyze_level_rows_sharded(slabs, bank, mesh)
            ref_ll, ref_det = dwt.analyze_level(x, bank)
            require(all(torch.equal(torch.cat(got), ref) for got, ref
                        in zip([ll, *det], [ref_ll, *ref_det])),
                    f"the row-sharded {name} level differs from analyze_level")

        # the sharded k-means on the DCT + vq flow's blocks
        vq_cfg = CodecConfig(quantizer="vq", entropy="zlib")
        vq_codec = Codec(vq_cfg, dev)
        coeff = vq_codec._analyze(dct_ops.pad_centered(
            vq_codec._upload(base).to(torch.float32), vq_cfg.block_size))
        blocks = vq.image_to_blocks(
            dct_ops.pad_centered(coeff, vq_cfg.vq_block_size),
            vq_cfg.vq_block_size)
        centres, labels, init = vq.kmeans_sharded(
            prng.PRNGKey(vq_cfg.seed), blocks, vq_cfg.vq_clusters, mesh)
        ref_c, ref_l = vq.kmeans(prng.PRNGKey(vq_cfg.seed), blocks,
                                 vq_cfg.vq_clusters,
                                 init_centers=torch.from_numpy(init).to(dev))
        centre_err = float(np.abs(centres - ref_c.cpu().numpy()).max())
        agreement = float((labels == ref_l.cpu().numpy()).mean())
        report["kmeans"] = {"points": list(blocks.shape),
                            "clusters": vq_cfg.vq_clusters,
                            "centre_max_abs_err": centre_err,
                            "label_agreement": agreement}
        require(centre_err <= KMEANS_CENTRE_ATOL
                and agreement >= MIN_LABEL_AGREEMENT,
                f"sharded k-means against kmeans: {report['kmeans']}")

        # one LBT step over 4 shards, against the same step on the CPU
        lbt_codec = Codec(CodecConfig(spatial="lbt"), dev)
        ct = lbt_codec._fwd(dct_ops.pad_centered(
            lbt_codec._upload(base).to(torch.float32), 8)
            - lbt_codec.spatial_offset)
        lb = lbt.blocks_of(ct, 8)
        lb = lb - lb.mean(0)
        rng = np.random.default_rng(0)
        w0 = lbt.dct_init(8)
        start = {"enc": w0 + rng.normal(0, LBT_INIT_NOISE, w0.shape),
                 "dec": w0.T + rng.normal(0, LBT_INIT_NOISE, w0.shape)}
        init_fn, step = lbt.train_step_fn()
        out = {}
        for where, d, blk in (("card", dev, lb), ("cpu", torch.device("cpu"),
                                                  lb.cpu())):
            params = {k: torch.from_numpy(v.astype(np.float32)).to(d)
                      for k, v in start.items()}
            out[where] = step(params, init_fn(params), list(blk.chunk(
                DIST_SHARDS)), Mesh((d,) * DIST_SHARDS))
        (p_g, _, loss_g), (p_c, _, loss_c) = out["card"], out["cpu"]
        lbt_err = max(float(((p_g[k].cpu() - p_c[k]).abs()
                             / p_c[k].abs()).max()) for k in p_c)
        report["lbt_step"] = {"blocks": list(lb.shape), "loss": float(loss_g),
                              "loss_cpu": float(loss_c),
                              "params_max_rel_err": lbt_err}
        require(bool(torch.isfinite(loss_g)) and lbt_err <= LBT_RTOL
                and abs(float(loss_g) - float(loss_c))
                <= LBT_RTOL * abs(float(loss_c)),
                f"LBT's sharded step against the CPU's: {report['lbt_step']}")

        # a world of one over NCCL
        t0 = time.perf_counter()
        dist.initialize(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl")
        report["nccl_init_s"] = time.perf_counter() - t0
        try:
            gmesh = dist.global_mesh()
            require(gmesh.devices == (dev,) and tdist.get_backend() == "nccl",
                    f"the NCCL mesh is {gmesh}")
            gen = torch.Generator(dev).manual_seed(0)
            hists = [torch.randint(0, 1 << 20, (1, 3, 4096), device=dev,
                                   generator=gen)
                     for _ in range(DIST_SHARDS)]
            group_mesh = Mesh((dev,) * DIST_SHARDS, group=gmesh.group)
            require(torch.equal(dist.allreduce_histogram(hists, group_mesh),
                                dist.allreduce_histogram(hists, mesh)),
                    "allreduce_histogram through NCCL differs")
            require(all(torch.equal(a, b) for a, b in zip(
                dist.replicate(lm_levels, group_mesh),
                dist.replicate(lm_levels, mesh))),
                "replicate through NCCL differs")
            lm_nccl = BatchCodec(lm_cfg, dev, mesh=group_mesh,
                                 shared_levels=True)
            require(np.array_equal(lm_nccl.encode_planes(frames), lm_planes)
                    and np.array_equal(lm_nccl.last_qside["levels"],
                                       lm_levels),
                    "the NCCL mesh's shared Lloyd-Max levels or planes differ")
        finally:
            tdist.destroy_process_group()

        # two Gloo processes on the card: this process's encodes meanwhile
        codec = Codec(CodecConfig(entropy="grans"), dev)
        streams = [sha256(codec.encode(f).to_bytes()) for f in frames]
        t0 = time.perf_counter()
        gloo = finish_workers(procs)
        report["gloo_wait_s"] = time.perf_counter() - t0
        for key in ("hist_ok", "psum_ok", "replicate_ok", "dwt_ok", "lbt_ok",
                    "kmeans_ok", "imports_clean"):
            require(gloo[key] is True, f"gloo workers: {key} is {gloo[key]}")
        require(gloo["processes"] == 2 and gloo["backend"] == "gloo"
                and gloo["device"] == str(dev), f"gloo workers: {gloo}")
        require(gloo["stream_sha"] == streams,
                "the gathered streams differ from this process's encodes")
        require(gloo["planes_sha"] == [sha256(p.tobytes()) for p in lm_planes]
                and gloo["levels_sha"] == sha256(
                    np.ascontiguousarray(lm_levels).tobytes()),
                "the two ranks' shared Lloyd-Max levels or planes differ from "
                "one process's")
    finally:
        stop_workers(procs)
    report["seconds"] = time.perf_counter() - t_phase
    print(f"distribution: {json.dumps(report)}")
    print(f"phase 4k: {report['seconds']:.1f} s")
    return total


def main() -> None:
    dev = phase_device()
    phase_build()
    from vcf_tpu_torch import Codec, CodecConfig

    base, frames = clip_frames()
    planes = index_planes(Codec(CodecConfig(entropy="grans"), device=dev),
                          frames)
    results = phase_kernels(dev, planes)
    phase_k1_ragged(dev)
    results += phase_dct_kernels(dev, frames)
    from vcf_tpu_torch.io import test_video

    clip = test_video(FRAMES, H, W, seed=7)
    results += phase_motion_kernels(dev, clip)
    results.append(dwt_row())
    results += dwt_ends_rows(frames)
    ctx_rows, ctx_words, ctx_grids = phase_ctx_kernels(dev, planes)
    results += ctx_rows
    grid_rows = phase_grid_kernels(dev, frames, ctx_grids)
    del ctx_grids
    launches = phase_main_path(dev, frames, planes)
    clip_launches, grans_clip, perceptual_rec = phase_clip(dev, frames, planes)
    launches.update(clip_launches)
    # the lane-grid modes' launches: the sum over the paths that run them
    grid_launches = {}
    for counts in (*phase_grid_clip(dev, frames, grans_clip, perceptual_rec),
                   phase_ipp_grid(dev, clip)):
        for name, count in counts.items():
            grid_launches[name] = grid_launches.get(name, 0) + count
    # the luma kernel runs on the planar grid loop alone (4g)
    launches["luma"] = grid_launches.pop("luma")
    ipp_launches, ipp_run = phase_ipp(dev, clip)
    launches.update(ipp_launches)
    launches.update(phase_cgrans_clip(dev, frames, planes, ctx_words,
                                      grans_clip))
    ctx_grid_launches, dwt_grid, bank_launches, end_launches = phase_dwt(
        dev, base)
    # the DWT level kernels and the clip path's ends run on 4e's encodes and
    # decodes (3g times them alone)
    launches["dwt_level"], dwt_synthesis_launches = bank_launches
    launches.update(end_launches)
    phase_host_codecs(dev, base)
    # 4i's launches add to the paths' counts: srans and the generic IPP
    # loop's DWT grans still codec launch K1-K3, its P frames SAD and MC
    for name, count in phase_compositions(dev, base, clip).items():
        launches[name] += count
    # 4j's CLI runs add to the counts of the kernels their paths reach
    for name, count in phase_entry_points(dev, base, clip, ipp_run).items():
        launches[name] += count
    # 4k's in-process meshes add theirs (the Gloo workers' own processes
    # are not counted)
    iii_run = (grans_clip[0], grans_clip[3])
    for name, count in phase_distribution(dev, base, frames, clip, iii_run,
                                          ipp_run).items():
        launches[name] += count
    grid_launches["rans_decode_ctx_grid"] = \
        ctx_grid_launches["rans_decode_ctx_grid"]
    for row in results:
        row["launches"] = launches[row["name"]]
        row.update(dwt_grid.get(row["name"], {}))
        if row["name"] == "dwt_level":
            row["synthesis_launches"] = dwt_synthesis_launches
    for row in grid_rows:
        row["launches"] = grid_launches[row["name"].split("[")[0]]
        row.update(dwt_grid.get(row["name"], {}))
    print(json.dumps({"kernels": results + grid_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
