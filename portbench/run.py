"""Benchmark of vcf_tpu_torch on the card: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cell's cards.  It
exits with code 2 and prints no result when no CUDA card is visible, or
fewer than the cell asks for.  Set-up, the window and the check are in
core/harness.py.  The last lines of standard error give each number
compared beside its limit; the last line of standard output is one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with --trace 1 its per-layer metrics), `device`,
with --trace 1 `breakdown`, `spans_ms` (device ms a call under each
benchmark span) and `work` (the counts the roofline shares read), then
`setup_split_s`, `check_s` (the reference check's seconds) and last
`checks`.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

#: top-level modules that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "vcf_tpu")


def forbidden_modules() -> list:
    """Forbidden top-level names in sys.modules, compared whole (so
    `vcf_tpu_torch` is not `vcf_tpu`)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def breakdown(rec: dict) -> dict:
    """The device ops that took most time and the longest idle gaps by
    the host op that launched the next device item, over both halves'
    profiled slices (at most 10 each)."""
    ops, gaps = {}, {}
    for half, name in (("enc", "encode"), ("dec", "decode")):
        t = rec[half]["trace"]
        for k, v in t.device_ops().items():
            ops[f"{name}: {k}"] = v
        for k, v in t.idle_gaps().items():
            gaps[f"{name}: {k}"] = v
    top = lambda d: [[k, v] for k, v in sorted(d.items(),  # noqa: E731
                                               key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench.core import discover, harness

    torch.set_num_threads(1)         # one process with few threads

    bench = discover.benchmark()
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); "
              f"{cards} visible", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    rec = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), device, T_START, bench=bench)

    e2e, per_layer = discover.cell_metrics(bench, args.workload)
    metrics = {}
    for m in (per_layer if args.trace else e2e):
        kind = "layer_metrics" if args.trace else "end_to_end"
        value = discover.load_module(kind, m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": entry["chips"],
           "memory_peak_bytes": rec["memory_peak_bytes"]}
    result = {"correct": rec["correct"], "attempted": rec["attempted"],
              "failed": rec["failed"], "metrics": metrics, "device": dev}
    if args.trace:
        traces = [rec[h]["trace"] for h in ("enc", "dec")]
        dev["busy_s"] = sum(t.busy_s for t in traces)
        dev["window_s"] = sum(t.window_s for t in traces)
        result["breakdown"] = breakdown(rec)
        result["spans_ms"] = {
            name: {span: t.span_s(span) / t.calls * 1e3
                   for span in sorted(t.span_names())}
            for name, t in zip(("encode", "decode"), traces)}
        result["work"] = rec["work"]
    result["setup_split_s"] = rec["setup_split_s"]
    result["check_s"] = rec["check_s"]
    result["checks"] = rec["checks"]

    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for err in rec["errors"]:
        print(f"error: {err}", file=sys.stderr)
    if args.trace:
        for h in ("enc", "dec"):
            t = rec[h]["trace"]
            print(f"trace {h}: {t.calls} calls, {len(t.items)} device items, "
                  f"{t.attributed} with their launch", file=sys.stderr)
    for name, c in rec["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
