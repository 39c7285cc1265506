"""A whole run (without the look for a card, on the CPU at the small
size) with the timed path broken underneath comes out not correct, once
for each fault these cells can have: a coded word altered where it is
produced; half of the clip left out (its first half coded twice); a
decode that returns its state unchanged (its first answer, every time);
a decoded frame altered.  The cells run on one chip, so no exchange
between chips can be left out."""

import time

import pytest
import torch

from portbench.core import harness
from portbench.tests import _small


def _word_altered(route, clips):
    encode = route.encode

    def broken(clip):
        stream = list(encode(clip))
        first = stream[0]
        if first.dtype == torch.int32:            # a raw grid: a low bit
            first = first.clone()
            t, s = ((first >> 16) != 0).nonzero()[0].tolist()
            first[t, s] ^= 1
        else:                                     # wire words
            first = first.view(torch.int16).clone()
            first[0] ^= 1
            first = first.view(torch.uint16)
        stream[0] = first
        return tuple(stream)
    route.encode = broken


def _half_left_out(route, clips):
    encode = route.encode

    def broken(clip):
        half = clip[:clip.shape[0] // 2]
        return encode(torch.cat([half, half]))
    route.encode = broken


def _state_unchanged(route, clips):
    decode = route.decode
    first = []

    def broken(stream):
        if not first:
            first.append(decode(stream))
        return first[0]
    route.decode = broken


def _answer_altered(route, clips):
    decode = route.decode

    def broken(stream):
        out = decode(stream).clone()
        out[0] = 255 - out[0]
        return out
    route.decode = broken


FAULTS = {"word_altered": _word_altered, "half_left_out": _half_left_out,
          "state_unchanged": _state_unchanged,
          "answer_altered": _answer_altered}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _small.checkout(tmp_path_factory.mktemp("faults"))


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", _small.CELLS)
def test_fault_is_not_correct(root, cell, fault):
    rec = harness.run(cell, 2 ** 31 + 5, 0.1, False, torch.device("cpu"),
                      time.perf_counter(), root=root,
                      route_hook=FAULTS[fault])
    assert not rec["correct"], rec["checks"]


@pytest.mark.parametrize("cell", _small.CELLS)
def test_sound_run_is_correct(root, cell):
    rec = harness.run(cell, 2 ** 31 + 5, 0.1, False, torch.device("cpu"),
                      time.perf_counter(), root=root)
    assert rec["correct"], rec["checks"]
