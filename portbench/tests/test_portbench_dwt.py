"""The DWT intra cell `dwt_wire_8f` in a checkout of the benchmark at a
size a CPU test run can hold (`_small.checkout`, 64 x 128 frames, the
cell's clips cut to 2 frames), with the cell's own limits: a sound run is
correct, the control (the reference computed in TF32 in the program's
place) breaks at least one limit, and a run with the timed path broken
underneath comes out not correct, once for each fault of
`test_portbench_faults.FAULTS`."""

import json
import time

import pytest
import torch

from portbench import control
from portbench.core import harness
from portbench.tests import _small
from portbench.tests.test_portbench_faults import FAULTS

CELL = "dwt_wire_8f"
SEED = 2 ** 31 + 7


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = _small.checkout(tmp_path_factory.mktemp("dwt"))
    path = root / "portbench" / "workloads" / f"{CELL}.json"
    workload = json.loads(path.read_text())
    workload["traffic"]["frames"] = 2
    path.write_text(json.dumps(workload))
    return root


def test_sound_run_is_correct(root):
    r = control.readings(CELL, SEED, 0.1, torch.device("cpu"), root)
    assert r["correct"] and not r["over_limit"], r


def test_control_breaks_a_limit(root):
    r = control.readings(CELL, SEED, 0.1, torch.device("cpu"), root,
                         control=True)
    assert not r["correct"] and r["over_limit"], r


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(root, fault):
    rec = harness.run(CELL, SEED, 0.1, False, torch.device("cpu"),
                      time.perf_counter(), root=root,
                      route_hook=FAULTS[fault])
    assert not rec["correct"], rec["checks"]
