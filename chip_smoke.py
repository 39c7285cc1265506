"""Drive the PyTorch + CUDA port (vcf_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (PATH or /usr/local/cuda/bin); builds the
kernels from vcf_tpu_torch/csrc on first use.  Phases:

1. device: the card's name and power limit; TF32 off for every matmul;
2. build: nvcc for sm_90a into vcf_tpu_torch/_build, timed;
3. rANS kernels K1-K3: each against its plain torch version on the card,
   on the index planes of 8 rolled 1088x1920 frames (S=65536 lanes,
   L=765 steps, 64 subband tables), bit-exact, with CUDA-event times of
   both;
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
   sad_search with ref = frames 0..6 and cur = frames 1..7 (m=16, s=8)
   against its plain version (0 differing mvs, SAD max_abs_err 0), and
   mc_apply_planar / mc_apply (channel-last) on the (7, 3, 1088, 1920)
   float32 frames with seeded mvs in [-8, 8], the frame-edge blocks
   pointing out of the frame, bit-exact; CUDA-event times of each;
4c. main path, IPP: IPPCodec(VideoConfig(mode="ipp", n_frames=8,
   gop_size=4, me_block=16, search_range=8), CodecConfig(entropy="grans",
   subbands=False), "cuda") encode -> bytes -> decode of that clip (SAD,
   MC, B1/B2 and K1-K3 must launch; the decoded index planes equal the
   encoded ones; the decoded frames equal the encoder's closed-loop
   reconstruction; rmse within 1e-2 of the port's CPU run of the whole
   clip, with the share of mv blocks and indexes that differ, and equal
   streams when none differs), with warm encode/decode times and the
   split of each into its device loop and its entropy stage.

Each path's launch counts are set to 0 just before it runs and read just
after.  Any failed check raises (non-zero exit, no result).  The last
two lines are one JSON object of kernel results and one of the device.
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


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    require(a.shape == b.shape, f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


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


def index_planes(codec, frames: np.ndarray) -> torch.Tensor:
    """(N, H, W, 3) u8 frames -> stored u8 index planes on the codec's
    device, as Codec.encode computes them."""
    from vcf_tpu_torch.ops import dct as dct_ops

    out = []
    for f in frames:
        x = torch.from_numpy(np.ascontiguousarray(f)).to(codec.device)
        padded = dct_ops.pad_centered(x.to(torch.float32), 8)
        k = codec._quantize(codec._analyze(padded))
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

    words = w_k[:n].clone()
    out_k = rd.rans_decode_grouped(words, st_k, fg, cg, l, c_k)
    out_p = rd.rans_decode_grouped_ref(words, st_k, fg, cg, l, c_k)
    err3 = max_abs_err(out_k, out_p)
    require(err3 == 0, f"K3 differs from its plain version by {err3}")
    require(torch.equal(out_k, lanes), "K3 output differs from the lanes")
    print(f"kernels: bit-exact; {n} words, "
          f"{n * 16 / lanes.numel():.4f} bits/symbol")

    rows = [
        ("rans_encode_grouped", "vcf_tpu_torch/csrc/rans_encode.cu",
         "vcf_tpu/ops/pallas/rans_encode.py:671", err1,
         lambda: re_.rans_encode_grouped(lanes, fg, cg),
         lambda: re_.rans_encode_grouped_ref(lanes, fg, cg), 20, 5),
        ("rans_compact", "vcf_tpu_torch/csrc/rans_encode.cu",
         "vcf_tpu/ops/pallas/rans_encode.py:858", err2,
         lambda: re_.rans_compact(raw_k),
         lambda: re_.rans_compact_ref(raw_k), 20, 5),
        ("rans_decode_grouped", "vcf_tpu_torch/csrc/rans_decode.cu",
         "vcf_tpu/ops/pallas/rans_decode.py:410", err3,
         lambda: rd.rans_decode_grouped(words, st_k, fg, cg, l, c_k),
         lambda: rd.rans_decode_grouped_ref(words, st_k, fg, cg, l, c_k),
         3, 3),
    ]
    results = []
    for name, src, rep, err, kern, plain, reps_k, reps_p in rows:
        ms = cuda_ms(kern, reps_k)
        plain_ms = cuda_ms(plain, reps_p)
        print(f"time {name}: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms")
        results.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": 0, "max_abs_err": err,
                        "diff_share": 0.0, "ms": ms, "plain_ms": plain_ms})
    return results


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
    src = "vcf_tpu_torch/csrc/dct.cu"
    rep = "vcf_tpu/ops/pallas/dct_kernel.py:"
    rows = [
        ("fused_dct_quantize", "153", b1p,
         lambda: dk.fused_dct_quantize(ct, perceptual=True),
         lambda: dk.fused_dct_quantize_ref(ct, perceptual=True)),
        ("fused_dequantize_idct", "207", b2p,
         lambda: dk.fused_dequantize_idct(k1p, perceptual=True),
         lambda: dk.fused_dequantize_idct_ref(k1p, perceptual=True)),
        ("fused_cdct_quantize", "298", b3,
         lambda: dk.fused_cdct_quantize(px, mf),
         lambda: dk.fused_cdct_quantize_ref(px, mf)),
        ("fused_dequantize_cdct", "334", b4,
         lambda: dk.fused_dequantize_cdct(k3, mi),
         lambda: dk.fused_dequantize_cdct_ref(k3, mi)),
    ]
    results = []
    for name, line, (err, share), kern, plain in rows:
        ms, plain_ms = cuda_ms(kern, 20), cuda_ms(plain, 5)
        print(f"time {name}: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms")
        results.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep + line, "launches": 0,
                        "max_abs_err": err, "diff_share": share, "ms": ms,
                        "plain_ms": plain_ms})
    # B1/B2 in plain mode too (BatchCodec's color="none" route)
    k1, _, _ = modes[False]
    print(f"time plain mode: fused_dct_quantize "
          f"{cuda_ms(lambda: dk.fused_dct_quantize(ct), 20):.4f} ms, "
          f"fused_dequantize_idct "
          f"{cuda_ms(lambda: dk.fused_dequantize_idct(k1), 20):.4f} ms")
    return results


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
    k_dec = codec._load_indexes(cs2, offset=codec.spatial_offset, signed=True)
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
        (rec, planes, grans["bpp"])


def phase_motion_kernels(dev, clip: np.ndarray) -> list:
    from vcf_tpu_torch.ops import motion
    from vcf_tpu_torch.ops.cuda import mc_kernel as mk
    from vcf_tpu_torch.ops.cuda import sad_kernel as sk

    x = torch.from_numpy(clip).to(dev)
    luma = motion.to_luma(x)
    ref_l, cur_l = luma[:-1].contiguous(), luma[1:].contiguous()
    mv_k, sad_k = sk.sad_search(ref_l, cur_l, ME_BLOCK, SEARCH)
    mv_p, sad_p = sk.sad_search_ref(ref_l, cur_l, ME_BLOCK, SEARCH)
    torch.cuda.synchronize()
    n_mv = int((mv_k != mv_p).any(-1).sum())
    sad_err = float((sad_k - sad_p).abs().max())
    require(n_mv == 0 and sad_err == 0,
            f"sad_search differs from its plain version: {n_mv} mvs, "
            f"SAD max {sad_err}")
    moving = float((mv_k != 0).any(-1).double().mean())

    g, h, w = cur_l.shape
    frames = x[:-1].permute(0, 3, 1, 2).to(torch.float32).contiguous()
    rng = np.random.default_rng(5)
    mv = rng.integers(-SEARCH, SEARCH + 1,
                      (g, h // ME_BLOCK, w // ME_BLOCK, 2)).astype(np.int32)
    mv[:, 0, :, 0], mv[:, -1, :, 0] = -SEARCH, SEARCH   # out of the frame
    mv[:, :, 0, 1], mv[:, :, -1, 1] = -SEARCH, SEARCH
    mv_t = torch.from_numpy(mv).to(dev)
    out_k = mk.mc_apply_planar(frames, mv_t, ME_BLOCK)
    mc_err = float((out_k - mk.mc_apply_planar_ref(frames, mv_t, ME_BLOCK)
                    ).abs().max())
    frames_cl = frames.permute(0, 2, 3, 1).contiguous()
    out_cl = mk.mc_apply(frames_cl, mv_t, ME_BLOCK)
    cl_err = float((out_cl - mk.mc_apply_ref(frames_cl, mv_t, ME_BLOCK)
                    ).abs().max())
    torch.cuda.synchronize()
    require(mc_err == 0 and cl_err == 0,
            f"MC kernel differs from its plain version: planar {mc_err}, "
            f"channel-last {cl_err}")
    require(torch.equal(out_cl, out_k.permute(0, 2, 3, 1)),
            "the two MC layouts disagree")
    print(f"motion kernels: {g}x{h}x{w}, m={ME_BLOCK} s={SEARCH}: SAD mvs "
          f"and SADs equal ({moving:.3f} of blocks move); MC planar and "
          "channel-last bit-exact")

    rows = [
        ("sad_search", "vcf_tpu/ops/pallas/sad_kernel.py:58",
         "vcf_tpu/ops/pallas/sad_kernel.py:141", sad_err,
         lambda: sk.sad_search(ref_l, cur_l, ME_BLOCK, SEARCH),
         lambda: sk.sad_search_ref(ref_l, cur_l, ME_BLOCK, SEARCH)),
        ("mc_apply_planar", "vcf_tpu/ops/pallas/mc_kernel.py:115",
         "vcf_tpu/ops/pallas/mc_kernel.py:103", mc_err,
         lambda: mk.mc_apply_planar(frames, mv_t, ME_BLOCK),
         lambda: mk.mc_apply_planar_ref(frames, mv_t, ME_BLOCK)),
    ]
    results = []
    for name, rep, also, err, kern, plain in rows:
        ms, plain_ms = cuda_ms(kern, 20), cuda_ms(plain, 3)
        print(f"time {name}: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms")
        results.append({"name": name, "route": "cuda",
                        "source": "vcf_tpu_torch/csrc/motion.cu",
                        "replaces": rep, "also_replaces": also, "launches": 0,
                        "max_abs_err": err, "diff_share": 0.0, "ms": ms,
                        "plain_ms": plain_ms})
    print(f"time mc_apply (channel-last): kernel "
          f"{cuda_ms(lambda: mk.mc_apply(frames_cl, mv_t, ME_BLOCK), 20):.4f}"
          f" ms, plain torch "
          f"{cuda_ms(lambda: mk.mc_apply_ref(frames_cl, mv_t, ME_BLOCK), 3):.4f}"
          " ms")
    return results


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
    for fn in kernels.values():
        fn.launches = 0
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
        mode = rc.decode_table_mode(g, n_ctx)
        times = {
            "ms": cuda_ms(lambda: rc.rans_encode_ctx(lanes, fg, cg), 20),
            "plain_ms": cuda_ms(lambda: rc.rans_encode_ctx_ref(lanes, fg, cg),
                                3),
            "dec_ms": cuda_ms(lambda: rc.rans_decode_ctx(words, st_k, fg, cg,
                                                         l, c_k), 3),
            "dec_plain_ms": cuda_ms(lambda: rc.rans_decode_ctx_ref(
                words, st_k, fg, cg, l, c_k), 2)}
        out[n_ctx] = (err1, err3, mode, times, words)
        print(f"ctx kernels: {n_ctx} classes, S={s_streams} L={l} G={g}: "
              f"bit-exact; {n} words, {n * 16 / lanes.numel():.4f} bits/symbol; "
              f"tables {t_tables:.2f} s (host); decode tables in {mode} memory")
        print(f"time rans_encode_ctx ({n_ctx} classes): kernel "
              f"{times['ms']:.4f} ms, plain torch {times['plain_ms']:.4f} ms")
        print(f"time rans_decode_ctx ({n_ctx} classes, {mode} tables): kernel "
              f"{times['dec_ms']:.4f} ms, plain torch "
              f"{times['dec_plain_ms']:.4f} ms")
    rows = []
    for name, src, rep, also, ms_key, plain_key, err_i in (
            ("rans_encode_ctx", "vcf_tpu_torch/csrc/rans_encode.cu",
             "vcf_tpu/ops/pallas/rans_ctx.py:256",
             "vcf_tpu/ops/pallas/rans_ctx.py:142", "ms", "plain_ms", 0),
            ("rans_decode_ctx", "vcf_tpu_torch/csrc/rans_decode.cu",
             "vcf_tpu/ops/pallas/rans_ctx.py:510", None, "dec_ms",
             "dec_plain_ms", 1)):
        row = {"name": name, "route": "cuda", "source": src, "replaces": rep,
               "launches": 0,
               "max_abs_err": max(out[c][err_i] for c in (4, 15)),
               "diff_share": 0.0, "ms": out[4][3][ms_key],
               "plain_ms": out[4][3][plain_key],
               "ms_15_classes": out[15][3][ms_key],
               "plain_ms_15_classes": out[15][3][plain_key]}
        if also:
            row["also_replaces"] = also
        else:
            row["table_mode"] = {"4": out[4][2], "15": out[15][2]}
        rows.append(row)
    return rows, out[4][4]


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
    out = {}
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
    return out


def main() -> None:
    dev = phase_device()
    phase_build()
    from vcf_tpu_torch import Codec, CodecConfig
    from vcf_tpu_torch.io import test_image

    base = test_image(H, W, seed=3)
    frames = np.stack([np.roll(base, (7 * i, 13 * i), (0, 1))
                       for i in range(FRAMES)])
    planes = index_planes(Codec(CodecConfig(entropy="grans"), device=dev),
                          frames)
    results = phase_kernels(dev, planes)
    results += phase_dct_kernels(dev, frames)
    from vcf_tpu_torch.io import test_video

    clip = test_video(FRAMES, H, W, seed=7)
    results += phase_motion_kernels(dev, clip)
    ctx_rows, ctx_words = phase_ctx_kernels(dev, planes)
    results += ctx_rows
    launches = phase_main_path(dev, frames, planes)
    clip_launches, grans_clip = phase_clip(dev, frames, planes)
    launches.update(clip_launches)
    launches.update(phase_ipp(dev, clip))
    launches.update(phase_cgrans_clip(dev, frames, planes, ctx_words,
                                      grans_clip))
    phase_dwt(dev, base)
    for row in results:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
