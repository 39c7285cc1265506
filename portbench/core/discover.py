"""Finding a cell's files by the names in BENCHMARK.json.

A workload `<cell>` is `portbench/workloads/<cell>.json`; it names its
configuration (`portbench/configs/<config>.json`), its route
(`portbench/routes/<route>.py`) and its content generator
(`portbench/inputs/<generator>.py`).  A metric `<name>` is read by
`portbench/end_to_end/<name>.py` or `portbench/layer_metrics/<name>.py`.
Adding a cell, a configuration or a metric adds files; nothing here
lists them.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def bench_dir(root: Path = ROOT) -> Path:
    return root / "portbench"


def load_json(kind: str, name: str, root: Path = ROOT) -> dict:
    path = bench_dir(root) / kind / f"{name}.json"
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, root: Path = ROOT):
    path = bench_dir(root) / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    key = "portbench_" + kind + "_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str) -> tuple:
    """(end-to-end metrics, per-layer metrics) that `cell` reports: those
    whose `workloads` list it, or, without the key, every end-to-end
    metric and every per-layer metric whose `moves` the cell reports."""
    def listed(m):
        return cell in m["workloads"] if "workloads" in m else None

    e2e = [m for m in bench["end_to_end"] if listed(m) in (True, None)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if listed(m) or (listed(m) is None and m["moves"] in names)]
    return e2e, per_layer


def require(config: dict, implements: dict) -> None:
    """Refuse a configuration that states another value of a field than
    the route and the reference implement, or leaves one out: it would
    run the default composition under its own name."""
    bad = {k: config.get(k, "<missing>") for k, v in implements.items()
           if config.get(k, "<missing>") != v}
    if bad:
        raise ValueError(f"configuration {config.get('name')!r} states "
                         f"{bad}; the route implements only "
                         f"{ {k: implements[k] for k in bad} }")


def cell(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The BENCHMARK.json entry of workload `name`, its workload file and
    its configuration file, in one dict."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    workload = load_json("workloads", name, root)
    return {"entry": entry, "workload": workload,
            "config": load_json("configs", entry["config"], root)}
