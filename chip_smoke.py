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
   prebuilt source index, and the wrapper's host time a call);
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
   (cgrans and grans) against the port's CPU run, K1 (context mode,
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
   instance and MC's vector mode launched); rmse, bpp, encode/decode
   times, the GOP-loop encode split by CUDA events into luma, SAD, MC,
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
   m=16 instance, MC's vector mode and K1-K3 must launch.

Each path's launch counts are set to 0 just before it runs and read just
after.  Any failed check raises (non-zero exit, no result).  The last
two lines are one JSON object of kernel results (with each kernel's
bound: the larger of its bytes over HBM's rate and its operations over
the peak rate of their type) and one of the device.
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
# 4i's IPP row: the generic loop over the first frames of the 4c clip
GENERIC_FRAMES = 4
# the least time the card could take (H100 SXM at its 700 W limit):
# bytes over HBM's rate, operations over the float32 peak (the type of
# every function replaced here).  Integer operations (the rANS kernels)
# have no peak there: their bound counts bytes.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


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
    operations."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    if t_ops > t_bytes:
        return {"bound_ms": t_ops, "bound_by": "operations"}
    return {"bound_ms": t_bytes, "bound_by": "bytes"}


def kernel_row(name: str, source: str, replaces: str, err, ms: float,
               plain_ms: float, bnd: dict, library_ms=None, **extra) -> dict:
    """One entry of the kernels line; `launches` is filled in from the
    main path's run."""
    return {"name": name, "route": "cuda",
            "source": f"vcf_tpu_torch/csrc/{source}",
            "replaces": f"vcf_tpu/ops/pallas/{replaces}", "launches": 0,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd,
            "library_ms": library_ms, **extra}


def dct_ops_per_elem(b: int, perceptual: bool = False,
                     color: bool = False) -> int:
    """Operations per element of B1-B4 (a multiply-add counts 2): two
    b-term passes, the quantizer's multiply and add, the perceptual
    multiply, the 3-term colour row."""
    return 4 * b + 2 + int(perceptual) + 5 * int(color)


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
    rows = [
        ("fused_dct_quantize", "153", b1p,
         lambda: dk.fused_dct_quantize(ct, perceptual=True),
         lambda: dk.fused_dct_quantize_ref(ct, perceptual=True),
         bound(nbytes(ct, k1p), n_el * dct_ops_per_elem(8, True))),
        ("fused_dequantize_idct", "207", b2p,
         lambda: dk.fused_dequantize_idct(k1p, perceptual=True),
         lambda: dk.fused_dequantize_idct_ref(k1p, perceptual=True),
         bound(nbytes(k1p, ct), n_el * dct_ops_per_elem(8, True))),
        ("fused_cdct_quantize", "298", b3,
         lambda: dk.fused_cdct_quantize(px, mf),
         lambda: dk.fused_cdct_quantize_ref(px, mf),
         bound(nbytes(px, k3), n_el * dct_ops_per_elem(8, color=True))),
        ("fused_dequantize_cdct", "334", b4,
         lambda: dk.fused_dequantize_cdct(k3, mi),
         lambda: dk.fused_dequantize_cdct_ref(k3, mi),
         bound(nbytes(k3, px), n_el * dct_ops_per_elem(8, color=True))),
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
    bnd = bound(nbytes(ct, k1), k1.numel() * dct_ops_per_elem(8))
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
        (rec, planes, grans["bpp"]), rec_p


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
    return results


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


def phase_ipp(dev, clip: np.ndarray) -> dict:
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
            "mc_apply_planar": launches["mc_apply_planar"]}


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
    grans_rec, grans_planes, grans_bpp = grans_clip
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


def phase_dwt(dev, frame: np.ndarray) -> dict:
    """4e: the 1088x1920 DWT still frame, cgrans and grans."""
    from vcf_tpu_torch import Codec, CodecConfig, CodeStream, metrics
    from vcf_tpu_torch.entropy import dwt_device as dd
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
    out, dwt_grid = {}, {}
    for ent in ("cgrans", "grans"):
        cfg = CodecConfig(spatial="dwt", qss=DWT_QSS, entropy=ent)
        codec = Codec(cfg, device=dev)
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        cs = codec.encode(frame)
        blob = cs.to_bytes()
        rec = codec.decode(CodeStream.from_bytes(blob))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in kernels.items()}
        print(f"dwt {ent} path: launches {launches}")
        for name in expect[ent]:
            require(launches[name] > 0,
                    f"kernel {name} was not launched on the DWT {ent} path")
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
    return ctx_launches, dwt_grid


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
    rows_spec = [
        ("fused_dct_quantize", "dct.cu", "dct_kernel.py:153", b12[True][1],
         lambda: dk.fused_dct_quantize(ct, perceptual=True, grid_layout=True),
         lambda: dk.fused_dct_quantize_ref(ct, perceptual=True,
                                           grid_layout=True), 20, 5,
         bound(nbytes(ct, k1p), n_el * dct_ops_per_elem(8, True))),
        ("fused_dequantize_idct", "dct.cu", "dct_kernel.py:207", b12[True][2],
         lambda: dk.fused_dequantize_idct(k1p, perceptual=True,
                                          grid_layout=True),
         lambda: dk.fused_dequantize_idct_ref(k1p, perceptual=True,
                                              grid_layout=True), 20, 5,
         bound(nbytes(k1p, ct), n_el * dct_ops_per_elem(8, True))),
        ("fused_cdct_quantize", "dct.cu", "dct_kernel.py:298", b3,
         lambda: dk.fused_cdct_quantize(px, mf, grid_layout=True),
         lambda: dk.fused_cdct_quantize_ref(px, mf, grid_layout=True), 20, 5,
         bound(nbytes(px, k3), n_el * dct_ops_per_elem(8, color=True))),
        ("fused_dequantize_cdct", "dct.cu", "dct_kernel.py:334", b4,
         lambda: dk.fused_dequantize_cdct(k3, mi, grid_layout=True),
         lambda: dk.fused_dequantize_cdct_ref(k3, mi, grid_layout=True),
         20, 5, bound(nbytes(k3, px), n_el * dct_ops_per_elem(8, color=True))),
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
    from vcf_tpu_torch.ops import motion
    from vcf_tpu_torch.ops.cuda import dct_kernel as dk
    from vcf_tpu_torch.ops.cuda import mc_kernel as mk
    from vcf_tpu_torch.ops.cuda import sad_kernel as sk

    targets = {"luma": (motion, "to_luma"), "SAD": (sk, "sad_search"),
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
    from vcf_tpu_torch.ops.cuda import mc_kernel as mk
    from vcf_tpu_torch.ops.cuda import rans_decode as rd
    from vcf_tpu_torch.ops.cuda import rans_encode as re_
    from vcf_tpu_torch.ops.cuda import sad_kernel as sk

    kernels = {"sad_search": sk.sad_search,
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
    launches = {"sad_search": sk.sad_search.launches,
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
    launches.update(phase_ipp(dev, clip))
    launches.update(phase_cgrans_clip(dev, frames, planes, ctx_words,
                                      grans_clip))
    ctx_grid_launches, dwt_grid = phase_dwt(dev, base)
    phase_host_codecs(dev, base)
    # 4i's launches add to the paths' counts: srans and the generic IPP
    # loop's DWT grans still codec launch K1-K3, its P frames SAD and MC
    for name, count in phase_compositions(dev, base, clip).items():
        launches[name] += count
    grid_launches["rans_decode_ctx_grid"] = \
        ctx_grid_launches["rans_decode_ctx_grid"]
    for row in results:
        row["launches"] = launches[row["name"]]
        row.update(dwt_grid.get(row["name"], {}))
    for row in grid_rows:
        row["launches"] = grid_launches[row["name"].split("[")[0]]
        row.update(dwt_grid.get(row["name"], {}))
    print(json.dumps({"kernels": results + grid_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
