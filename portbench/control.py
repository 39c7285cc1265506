"""Readings that set a cell's limits: the program's and the control's.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 4

Each seed is one whole run of the cell through the harness (set-up, a
short window of --seconds at the cell's own load, the check), as the
benchmark's command makes it, in one process.  For --seeds the program
runs: the lower readings.  For --control-seeds the route's `control`
puts the plain reference, computed in TF32, in the program's place after
set-up (its transform, closed loop, lane law and tables; the program's
entropy coder stays), and the same check with the same limits judges
it: the upper readings.  Prints one JSON line a seed with each number,
the numbers over their limits and `correct`, then the largest program
reading and the smallest control reading of each number.  The
benchmark's own runs do not run this.
"""

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def readings(cell: str, seed: int, seconds: float, device, root=None,
             control=False) -> dict:
    """One seed's run: {"numbers", "over_limit", "correct", "errors"}."""
    import torch

    from portbench.core import discover, harness

    root = root or discover.ROOT
    bench = discover.benchmark(root)
    route_mod = discover.load_module(
        "routes", discover.cell(bench, cell, root)["workload"]["route"], root)
    rec = harness.run(cell, seed, seconds, False, device,
                      time.perf_counter(), root=root, bench=bench,
                      route_hook=route_mod.control if control else None)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = rec["checks"]
    return {"numbers": {k: v["value"] for k, v in checks.items()},
            "over_limit": [k for k, v in checks.items()
                           if v["value"] is None or v["value"] > v["limit"]],
            "correct": rec["correct"], "errors": rec["errors"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    high, low = {}, {}
    for kind, seeds in (("program", args.seeds),
                        ("control", args.control_seeds)):
        for seed in [int(s) for s in seeds.split(",") if s]:
            r = readings(args.workload, seed, args.seconds, device,
                         control=kind == "control")
            print(json.dumps({"workload": args.workload, "kind": kind,
                              "seed": seed, **r}), flush=True)
            for k, v in r["numbers"].items():
                if kind == "program":
                    high[k] = max(high.get(k, v), v)
                else:
                    low[k] = min(low.get(k, v), v)
    print(json.dumps({"workload": args.workload,
                      "program_largest": high, "control_smallest": low}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
