"""The harness's own comparison separates the program from its control at
a size a CPU test run can hold: a run of the program keeps to every
limit of its cell, and a run with the control (the reference computed in
TF32 in the program's place) breaks at least one."""

import pytest
import torch

from portbench import control
from portbench.tests import _small


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _small.checkout(tmp_path_factory.mktemp("control"))


@pytest.mark.parametrize("cell", _small.CELLS)
def test_program_keeps_to_the_limits(root, cell):
    r = control.readings(cell, 2 ** 31 + 3, 0.1, torch.device("cpu"), root)
    assert r["correct"] and not r["over_limit"], r


@pytest.mark.parametrize("cell", _small.CELLS)
def test_control_breaks_a_limit(root, cell):
    r = control.readings(cell, 2 ** 31 + 3, 0.1, torch.device("cpu"), root,
                         control=True)
    assert not r["correct"] and r["over_limit"], r
