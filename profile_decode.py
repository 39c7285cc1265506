"""Profile the port's clip decodes on one GPU with torch.profiler.

    python3 profile_decode.py [--out profile_out]

Encodes chip_smoke.py's 8-frame 1088x1920 grans clip (chip_smoke.
clip_frames) through IIICodec and through the lane-grid wire route
(chip_smoke.grid_clip_route), then profiles one warm decode of each.
Prints one JSON line per decode:

- wall_ms: host clock around the profiled, synchronized call (the
  profiler adds host time); wall_ms_unprofiled: the median of 5 such
  calls without it;
- device_busy_ms: the union of the trace's kernel, copy and memset
  intervals; idle_share 1 - busy / wall and idle_share_unprofiled
  1 - busy / wall_ms_unprofiled;
- where the device waits in the profiled call: lead_ms from the first
  host op to the first device item, tail_ms after the last, gaps_ms
  between device items, and the largest gaps, each with the host op
  (outermost aten op) that launched the device item after it;
- largest_ms: the device items with the largest summed ms.

Writes each Chrome trace to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_waits(trace_path: str) -> dict:
    """Busy time and waits of the device in a trace (see the docstring)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    dev = sorted((e for e in events
                  if e.get("cat") in DEVICE_CATS and "dur" in e),
                 key=lambda e: e["ts"])
    if not dev:
        raise RuntimeError(f"{trace_path}: the trace holds no device event")
    host = [e for e in events if e.get("cat") in ("cpu_op", "cuda_runtime")
            and "dur" in e]
    # the runtime call of each device item, and the aten ops around it
    runtime = {e["args"].get("correlation"): e for e in host
               if e["cat"] == "cuda_runtime"}
    ops = [e for e in host if e["cat"] == "cpu_op"]

    def launcher(item) -> str:
        call = runtime.get(item["args"].get("correlation"))
        if call is None:
            return "?"
        around = [o for o in ops if o["ts"] <= call["ts"]
                  and call["ts"] <= o["ts"] + o["dur"]]
        outer = min(around, key=lambda o: o["ts"]) if around else call
        return f"{outer['name']} / {call['name']}"

    by_name, busy, end, gaps = {}, 0.0, dev[0]["ts"], []
    for e in dev:
        a, b = e["ts"], e["ts"] + e["dur"]
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
        if a > end:
            gaps.append((a - end, launcher(e)))
        busy += max(b - max(a, end), 0.0)
        end = max(end, b)
    start = min(e["ts"] for e in host) if host else dev[0]["ts"]
    stop = max(e["ts"] + e["dur"] for e in host) if host else end
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"device_busy_ms": busy / 1e3,
            "lead_ms": (dev[0]["ts"] - start) / 1e3,
            "lead_launcher": launcher(dev[0]),
            "gaps_ms": sum(g for g, _ in gaps) / 1e3,
            "tail_ms": max(stop - end, 0.0) / 1e3,
            "largest_gaps_ms": [[g / 1e3, who] for g, who in
                                sorted(gaps, key=lambda x: -x[0])[:5]],
            "largest_ms": {k[:60]: v for k, v in top}}


def profile_call(name: str, fn, out_dir: str) -> dict:
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(6):          # the first is a warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    unprofiled = statistics.median(walls[1:])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    path = os.path.join(out_dir, f"{name}.json")
    prof.export_chrome_trace(path)
    waits = device_waits(path)
    busy = waits["device_busy_ms"]
    return {"call": name, "wall_ms": wall_ms,
            "wall_ms_unprofiled": unprofiled,
            "idle_share": 1.0 - busy / wall_ms,
            "idle_share_unprofiled": 1.0 - busy / unprofiled,
            **waits, "trace": path}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args()
    import chip_smoke as cs

    dev = cs.phase_device()   # no card: exits; else prints its name and limit
    os.makedirs(args.out, exist_ok=True)
    from vcf_tpu_torch import CodecConfig, CodeStream
    from vcf_tpu_torch.config import VideoConfig
    from vcf_tpu_torch.ops import color as color_ops
    from vcf_tpu_torch.ops.cuda import dct_kernel as dk
    from vcf_tpu_torch.ops.cuda import rans_encode as re_
    from vcf_tpu_torch.video import IIICodec

    _, frames = cs.clip_frames()
    iii = IIICodec(VideoConfig(n_frames=cs.FRAMES),
                   CodecConfig(entropy="grans"), dev)
    stream = CodeStream.from_bytes(iii.encode(frames).to_bytes())
    results = [profile_call("iii_clip_decode",
                            lambda: iii.decode(stream), args.out)]

    x = torch.from_numpy(frames).to(dev)
    lanes0, s_streams, cw = cs.grid_lanes_of(dk.fused_cdct_quantize(
        x.permute(0, 3, 1, 2), dk.static_mat(color_ops.YCOCG_FWD),
        grid_layout=True))
    fg, cg, _ = cs.grid_tables(dev, lanes0)
    _, counts0, _ = re_.rans_encode_rows(lanes0.t(), fg, cg)
    cap = min(max(-(-int(counts0.max()) * 2 // 128) * 128, 128), s_streams)
    n, h, w, _ = frames.shape
    _, _, encode_wire, decode_wire, _, _ = cs.grid_clip_route(
        dev, fg, cg, lanes0.shape[0], s_streams, cw, n, h, w)
    words, n_words, st, counts = encode_wire(x, cap)
    results.append(profile_call(
        "lane_grid_wire_decode",
        lambda: decode_wire(words, n_words, st, counts), args.out))
    for r in results:
        print(json.dumps(r))


if __name__ == "__main__":
    main()
