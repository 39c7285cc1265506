"""The benchmark's command on the card: a short run of every cell comes
out correct and prints its metrics.  Marked `cuda`; skips without a
card.  Without one, the command exits 2 and prints no result.

    python3 -m pytest portbench/tests/test_portbench_cuda.py -m cuda
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.core import discover

REPO = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in discover.benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def _run(cell, trace):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 17), "--seconds", "2", "--trace", str(trace)],
        cwd=REPO, capture_output=True, text=True, timeout=900)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", (0, 1))
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell, trace):
    out = _run(cell, trace)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0
    assert result["device"]["platform"] == "gpu" and result["metrics"]
    assert list(result)[-1] == "checks"


def test_no_card_no_result(no_card):
    out = _run(CELLS[0], 0)
    assert out.returncode == 2 and not out.stdout.strip()
