"""A checkout of the benchmark at a size a CPU test run can hold: the
cells' files copied into a temporary root, with the deferred cell
`iii_device_32f` added, the frames cut to 64 x 128 and the clips to 4
frames (III) or 2 GOPs of 10 (IPP).  The limits stay the cells' own."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
FRAMES = {"iii_wire_32f": 4, "iii_device_32f": 4, "ipp_grid_80f": 20}
CELLS = tuple(FRAMES)
#: `iii_device_32f`, left out of BENCHMARK.json until the grid decode no
#: longer waits on the host (PERF.md, Open questions): its route and
#: limits are kept, and tested here as a cell of the small checkout
DEFERRED = {
    "workload": {
        "name": "iii_device_32f", "config": "iii-dct-grans-1080p",
        "route": "lanegrid_device",
        "traffic": {"name": "rolled_32f_device", "generator": "rolled_image",
                    "frames": 32, "pool": 4},
        "trace_calls": 8,
        "limits": {"enc_index_diff_share": 2.5e-05,
                   "enc_index_diff_over1": 0, "stream_errors": 0,
                   "table_diff_entries": 18, "dec_pixel_diff_share": 0.004,
                   "dec_pixel_diff_over1": 0}},
    "entry": {"name": "iii_device_32f", "config": "iii-dct-grans-1080p",
              "traffic": "rolled_32f_device", "chips": 1,
              "why": "as iii_wire_32f, the stream left device-resident"}}


def _edit(path: Path, **changes) -> None:
    data = json.loads(path.read_text())
    for key, value in changes.items():
        if isinstance(value, dict):
            data[key].update(value)
        else:
            data[key] = value
    path.write_text(json.dumps(data, indent=1))


def checkout(tmp_path: Path) -> Path:
    """A root holding BENCHMARK.json and portbench/, at the small size."""
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    wl = DEFERRED["workload"]
    (root / "portbench" / "workloads" / f"{wl['name']}.json").write_text(
        json.dumps(wl))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(DEFERRED["entry"])
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for cfg in (root / "portbench" / "configs").glob("*.json"):
        _edit(cfg, height=64, width=128)
    for cell, frames in FRAMES.items():
        _edit(root / "portbench" / "workloads" / f"{cell}.json",
              traffic={"frames": frames})
    return root
