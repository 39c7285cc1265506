"""The harness finds a cell's files by name, and BENCHMARK.json keeps to
the benchmark's contract."""

import hashlib
import json
import re
import shutil
import time

import pytest
import torch

from portbench.core import discover, harness
from portbench.tests import _small

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _tree_hash(root):
    h = hashlib.sha256()
    for path in sorted(root.rglob("*")):
        if path.is_file() and "__pycache__" not in path.parts:
            h.update(str(path.relative_to(root)).encode())
            h.update(path.read_bytes())
    return h.hexdigest()


def test_files_dropped_in_are_found(tmp_path):
    root = _small.checkout(tmp_path)
    before = _tree_hash(root / "portbench")
    bench_dir = root / "portbench"
    # a configuration, a workload and a per-layer metric, as files alone
    cfg = json.loads((bench_dir / "configs/iii-dct-grans-1080p.json")
                     .read_text())
    cfg["name"] = "iii-dct-grans-added"
    (bench_dir / "configs/iii-dct-grans-added.json").write_text(
        json.dumps(cfg))
    wl = json.loads((bench_dir / "workloads/iii_wire_32f.json").read_text())
    wl.update(name="added_cell", config="iii-dct-grans-added")
    wl["traffic"]["name"] = "rolled_added"
    (bench_dir / "workloads/added_cell.json").write_text(json.dumps(wl))
    (bench_dir / "layer_metrics/symbols_per_call.py").write_text(
        "def read(rec):\n    return float(rec['work']['symbols'])\n")
    assert _tree_hash(root / "portbench") != before
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({**bench["configs"][0],
                             "name": "iii-dct-grans-added"})
    bench["workloads"].append({"name": "added_cell",
                               "config": "iii-dct-grans-added",
                               "traffic": "rolled_added", "chips": 1,
                               "why": "a cell added as data"})
    bench["per_layer"].append({"name": "symbols_per_call", "unit": "count",
                               "better": "higher", "source": "program_counter",
                               "layer": "entropy", "moves": "decode_gbps",
                               "workloads": ["added_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    e2e, per_layer = discover.cell_metrics(bench, "added_cell")
    assert "symbols_per_call" in [m["name"] for m in per_layer]
    assert "setup_s" in [m["name"] for m in e2e]
    rec = harness.run("added_cell", 2 ** 31 + 11, 0.2, False,
                      torch.device("cpu"), time.perf_counter(), root=root)
    assert rec["correct"], rec["checks"]
    value = discover.load_module("layer_metrics", "symbols_per_call",
                                 root).read(rec)
    assert value == 4 * 3 * 64 * 128
    for m in e2e:
        assert discover.load_module("end_to_end", m["name"], root).read(
            rec) > 0


def test_the_files_of_every_cell_exist():
    bench = discover.benchmark()
    for w in bench["workloads"]:
        c = discover.cell(bench, w["name"])
        assert c["workload"]["traffic"]["name"] == w["traffic"]
        discover.load_module("routes", c["workload"]["route"])
        discover.load_module("inputs", c["workload"]["traffic"]["generator"])
        e2e, per_layer = discover.cell_metrics(bench, w["name"])
        names = [m["name"] for m in e2e]
        assert "setup_s" in names and len(names) >= 2 and per_layer
        for m in e2e:
            discover.load_module("end_to_end", m["name"])
        for m in per_layer:
            discover.load_module("layer_metrics", m["name"])


def test_benchmark_json_keeps_to_the_contract():
    bench = discover.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    cells = 24
    assert (2 + 14 * cells) * (bench["run_seconds"] + 60) + cells * 180 \
        + 1200 <= 43200
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert (discover.ROOT / c["file"]).is_file()
        assert len(c["why"]) <= 200 and len(c["source"]) <= 200
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in bench["end_to_end"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["moves"] in e2e and "\n" not in m["layer"]
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in bench["workloads"]}
    assert len(json.dumps(bench)) <= 64 * 1024


def test_small_checkout_leaves_the_repo_alone(tmp_path):
    before = _tree_hash(_small.REPO / "portbench")
    root = _small.checkout(tmp_path)
    shutil.rmtree(root)
    assert _tree_hash(_small.REPO / "portbench") == before


@pytest.mark.parametrize("cell, field, value", [
    ("ipp_grid_80f", "fast_search", True),
    ("ipp_grid_80f", "rdo_lambda", 0.5),
    ("iii_wire_32f", "color", "rgb"),
    ("iii_device_32f", "entropy", "cgrans"),
    ("iii_wire_32f", "prob_bits", 12),
])
def test_configuration_the_route_does_not_implement_is_refused(
        tmp_path, cell, field, value):
    root = _small.checkout(tmp_path)
    config = discover.cell(discover.benchmark(root), cell, root)["config"]
    path = root / "portbench" / "configs" / f"{config['name']}.json"
    path.write_text(json.dumps({**config, field: value}))
    with pytest.raises(ValueError, match=field):
        harness.run(cell, 2 ** 31 + 13, 0.1, False, torch.device("cpu"),
                    time.perf_counter(), root=root)
