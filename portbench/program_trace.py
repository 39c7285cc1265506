"""The program's spans and counters in one traced run of a cell.

    python3 portbench/program_trace.py --workload <cell> --seed <n> \
        --seconds <s>

One run of the cell as `run.py --trace 1` makes it (core/harness.run,
the same slices), which also keeps each slice's events for
core/program.py, and counts vcf_tpu_torch's counters
(`utils.profiling.counts`) around every call of the window.  Prints one
JSON line: the cell's per-layer metrics as run.py reads them, and for
each half the counters a call (mean over the half's calls), device ms a
call under each program kind (`program_ms`), idle ms a call in gaps
that open inside each kind (`idle_in_ms`), device ms a call by the
innermost program span (`innermost_ms`), for IPP the device ms a call
under `gop_loop` that no kind span (luma, pixels, layout) nor named
kernel (SAD, MC, B3/B4) holds (`gop_loop_rest_ms`), and the longest idle
gaps by benchmark span, program span and launcher.  With a CUDA card
only; the benchmark's own runs do not run this.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

#: the program kinds that split the IPP loop, and its named kernels
LOOP_KINDS = ("luma", "pixels", "layout")
LOOP_KERNELS = ("sad_search", "mc_vec_kernel", "mc_kernel",
                "dct_forward_kernel", "dct_inverse_kernel")


def _keeping_events(half_trace):
    """A `trace.HalfTrace` that also keeps the slice's events."""
    class Kept(half_trace):
        def __init__(self, events: list, calls: int):
            super().__init__(events, calls)
            self.events = events
    return Kept


def _count_calls(profiling, per_call: dict):
    """A route hook that records the counters' growth over each call."""
    def hook(route, clips):
        for name in ("encode", "decode"):
            fn, log = getattr(route, name), per_call[name]

            def counted(x, fn=fn, log=log):
                before = profiling.counts()
                out = fn(x)
                after = profiling.counts()
                log.append({k: after[k] - before[k] for k in after})
                return out
            setattr(route, name, counted)
    return hook


def loop_rest_s(half, spans) -> float:
    """Device seconds under the benchmark's `gop_loop` span outside every
    LOOP_KINDS span and every LOOP_KERNELS kernel."""
    rest = 0.0
    for _, dur, name, launch, _ in half.items:
        if (launch is None or "gop_loop" not in half.spans_at(launch)
                or any(k in name for k in LOOP_KERNELS)
                or any(spans.kind_open(k, launch) for k in LOOP_KINDS)):
            continue
        rest += dur
    return rest / 1e6


def half_report(half) -> dict:
    from portbench.core import program

    spans = program.ProgramSpans(half.events, half)
    n = half.calls
    out = {"program_ms": {k: spans.program_s(k) / n * 1e3
                          for k in spans.kinds()},
           "idle_in_ms": {k: spans.idle_in_s(k) / n * 1e3
                          for k in spans.kinds()}}
    out["innermost_ms"] = {k: v / n * 1e3
                           for k, v in sorted(spans.by_span_s().items())}
    if half.has_span("gop_loop"):
        out["gop_loop_rest_ms"] = loop_rest_s(half, spans) / n * 1e3
    gaps = sorted(spans.idle_gaps().items(), key=lambda kv: -kv[1])[:12]
    out["idle_gaps_ms"] = [[k, v / n * 1e3] for k, v in gaps]
    return out


def run(cell: str, seed: int, seconds: float, device, root=None) -> dict:
    from portbench.core import discover, harness
    from vcf_tpu_torch.utils import profiling

    root = root or discover.ROOT
    bench = discover.benchmark(root)
    per_call = {"encode": [], "decode": []}
    half_trace = harness.trace_mod.HalfTrace
    harness.trace_mod.HalfTrace = _keeping_events(half_trace)
    try:
        rec = harness.run(cell, seed, seconds, True, device,
                          time.perf_counter(), root=root, bench=bench,
                          route_hook=_count_calls(profiling, per_call))
    finally:
        harness.trace_mod.HalfTrace = half_trace
    _, per_layer = discover.cell_metrics(bench, cell)
    metrics = {m["name"]: discover.load_module("layer_metrics", m["name"],
                                               root).read(rec)
               for m in per_layer}
    report = {"workload": cell, "seed": seed, "correct": rec["correct"],
              "metrics": metrics}
    for h, name in (("enc", "encode"), ("dec", "decode")):
        # the window's calls are the last of each route call's log
        calls = per_call[name][-rec[h]["calls"]:]
        report[name] = {"counts": {k: sum(c[k] for c in calls) / len(calls)
                                   for k in calls[0]},
                        **half_report(rec[h]["trace"])}
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    print(json.dumps(run(args.workload, args.seed, args.seconds,
                         torch.device("cuda", 0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
