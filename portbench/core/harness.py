"""One run of one cell: set-up, the window, the check, the result line.

Set-up makes the cell's pool of clips on the device from the seed
(`inputs/<generator>.py`), builds the route (`routes/<route>.py`: the
kernel library from the program's own cache, the static tables), and
warms every shape the window uses: each clip encoded and decoded while
as many answers are held as the window holds.  The window is a closed
loop with one caller: the first half encodes the pool's clips round
robin, the second half decodes the streams the first half produced;
every call ends in a device synchronisation.  A call's latency is taken
by CUDA events recorded around it (the device is idle when it starts);
a half's rate is its pixel bytes over its wall time by the host clock.
With `trace`, a slice of each half runs under `torch.profiler`, with the
benchmark's spans open around the calls into each layer.  After the
window the program's state is freed, and the answers of a sample of the
calls drawn from the seed, with the last answer to each clip of each
half, are judged against the plain reference.
"""

from __future__ import annotations

import contextlib
import gc
import random
import time
import types

import torch

from portbench.core import discover, trace as trace_mod

#: calls of a half before its profiled slice
TRACE_FIRST = 2
#: answers of each half drawn from the seed for the check, besides the
#: last answer to each clip
CHECK_SAMPLES = 2


def span_factory(on: bool):
    if not on:
        return lambda name: contextlib.nullcontext()
    return lambda name: torch.profiler.record_function(
        trace_mod.PREFIX + name)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Sample:
    """A uniform sample of k answers of a half (reservoir sampling with a
    seeded generator)."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.kept, self.seen = k, rng, [], 0

    def offer(self, item) -> None:
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.kept[j] = item
        self.seen += 1


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def half(fn, inputs: list, seconds: float, device, sample: Sample,
         trace_calls: int, span, keep: dict = None) -> dict:
    """Call fn on inputs round robin for `seconds` (at least once each);
    `keep` receives each input index's last answer."""
    cuda = device.type == "cuda"
    if not inputs:
        return {"calls": 0, "failed": 0, "errors": [], "wall_s": 0.0,
                "ms": [], "trace": None}
    pairs, host_ms, failed, errors = [], [], 0, []
    prof, traced = None, None
    t0 = time.perf_counter()
    n = 0
    while True:
        i = n % len(inputs)
        if trace_calls and n == TRACE_FIRST:
            prof = _profiler(device)
            prof.start()
        with span("call") if prof is not None else contextlib.nullcontext():
            if cuda:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            t_call = time.perf_counter()
            try:
                out = fn(inputs[i])
            except Exception as exc:       # a failed call is counted
                out = None
                failed += 1
                if len(errors) < 3:
                    errors.append(f"{type(exc).__name__}: {exc}")
            if cuda:
                ev[1].record()
            sync(device)
        if cuda:
            pairs.append(ev)
        else:
            host_ms.append((time.perf_counter() - t_call) * 1e3)
        if out is not None:
            sample.offer((i, out))
            if keep is not None:
                keep[i] = out
        if prof is not None and n == TRACE_FIRST + trace_calls - 1:
            prof.stop()
            traced = trace_mod.read(prof, trace_calls)
            prof = None
        n += 1
        done_trace = not trace_calls or traced is not None
        if (time.perf_counter() - t0 >= seconds and n >= len(inputs)
                and done_trace):
            break
    wall = time.perf_counter() - t0
    ms = [a.elapsed_time(b) for a, b in pairs] if cuda else host_ms
    return {"calls": n, "failed": failed, "errors": errors, "wall_s": wall,
            "ms": ms, "trace": traced}


def warm(route, clips: list, held: int, device) -> tuple:
    """Encode and decode every clip while `held` answers are alive (the
    most the window holds), so the window finds every kernel built and
    the allocator's blocks in place.  Returns (one stream a clip, the
    errors of the calls that failed)."""
    streams, outs, errors = [], [], []
    for i in range(held):
        try:
            streams.append(route.encode(clips[i % len(clips)]))
            outs.append(route.decode(streams[-1]))
        except Exception as exc:           # counted as the window counts
            errors.append(f"warm-up: {type(exc).__name__}: {exc}")
    sync(device)
    del outs
    return streams[:len(clips)], errors


def setup_torch() -> None:
    """Full float32 on the card, as the program requires."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def reach_errors(route_mod, before: dict, after: dict) -> list:
    """The kernels a route should reach and did not, and those it should
    bypass and launched, between two counter snapshots."""
    bad = [f"{k} not launched" for k in route_mod.REACHES
           if after[k] <= before[k]]
    bad += [f"{k} launched" for k in route_mod.BYPASSES
            if after[k] != before[k]]
    return bad


def run(cell: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, root=discover.ROOT, bench=None,
        route_hook=None) -> dict:
    """One run; returns the pieces of the result (see run.py).
    route_hook(route, clips), if given, may replace the route's calls
    after its set-up (the control, the tests' faults)."""
    bench = bench or discover.benchmark(root)
    c = discover.cell(bench, cell, root)
    workload, config = c["workload"], c["config"]
    traffic = workload["traffic"]
    route_mod = discover.load_module("routes", workload["route"], root)
    gen = discover.load_module("inputs", traffic["generator"], root)
    span = span_factory(trace)
    setup_torch()
    marks = [("imports", time.perf_counter())]

    clips = gen.make(traffic, config, seed, device)
    sync(device)
    marks.append(("clips", time.perf_counter()))
    route = route_mod.setup(config, workload, clips, span)
    sync(device)
    marks.append(("route and tables", time.perf_counter()))
    if route_hook is not None:
        route_hook(route, clips)
    k = CHECK_SAMPLES
    streams, warm_errors = warm(route, clips, len(clips) + 2 * k + 1,
                                device)
    work = route.work(streams) if streams else {}
    del streams
    marks.append(("warm-up", time.perf_counter()))
    if trace:                              # start the profiler once, so
        prof = _profiler(device)           # the slices do not pay for it
        prof.start()
        torch.ones(1, device=device).add_(1)
        sync(device)
        prof.stop()
    counts0 = route.counters()
    sync(device)
    setup_s = time.perf_counter() - t_start
    split, last = {}, t_start
    for name, t in marks:
        split[name], last = t - last, t

    rng = random.Random(seed)
    enc_sample, dec_sample = Sample(k, rng), Sample(k, rng)
    trace_calls = workload["trace_calls"] if trace else 0
    keep, keep_dec = {}, {}
    gc.collect()
    gc.disable()                 # no collector pause inside the window
    try:
        enc = half(route.encode, clips, seconds / 2, device, enc_sample,
                   trace_calls, span, keep)
        inputs = [keep[i] for i in sorted(keep)]
        dec = half(route.decode, inputs, seconds / 2, device, dec_sample,
                   trace_calls, span, keep_dec)
    finally:
        gc.enable()
    failed = (enc["failed"] + dec["failed"] + len(clips) - len(inputs)
              + len(warm_errors))
    reach = (reach_errors(route_mod, counts0, route.counters())
             if device.type == "cuda" else [])
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)

    static = route.static()
    if hasattr(route, "close"):
        route.close()
    del route
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ctx = types.SimpleNamespace(
        clips=clips, static=static, streams=dict(zip(sorted(keep), inputs)),
        enc_samples=enc_sample.kept + sorted(keep.items()),
        dec_samples=dec_sample.kept + sorted(keep_dec.items()),
        config=config, workload=workload, device=device)
    t_check = time.perf_counter()
    numbers = route_mod.check(ctx)
    sync(device)
    check_s = time.perf_counter() - t_check
    limits = workload["limits"]
    checks = {name: {"value": numbers.get(name), "limit": limits[name]}
              for name in limits}
    correct = (failed == 0 and not reach
               and all(v["value"] is not None and v["value"] <= v["limit"]
                       for v in checks.values()))
    return {"cell": c, "correct": correct,
            "attempted": enc["calls"] + dec["calls"], "failed": failed,
            "errors": warm_errors[:3] + enc["errors"] + dec["errors"]
            + reach,
            "setup_s": setup_s, "setup_split_s": split, "enc": enc,
            "dec": dec, "work": work,
            "memory_peak_bytes": memory_peak, "check_s": check_s,
            "checks": checks}
