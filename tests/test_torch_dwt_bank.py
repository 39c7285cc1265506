"""The DWT level route (`ops.dwt.analyze_level` / `synthesize_level`) and
its kernel wrapper (`ops.cuda.dwt_kernel`) on the CPU.

- Its plain route is the torch FMA chains of `ops.dwt`, one chain a
  filter (`_down_pair`, `_column_bands`, `_up_pairs`), bit for bit, for
  every bank family, both row axes, one and three trailing channels, one
  and three frames, and levels down to 2 x 4.
- The launch arguments derived from a bank and a level's size
  (`ops.dwt.kernel_args`): taps in chain order, lengths, shifts or
  phases, and the first-pair fusing `ops.dwt._fuses_first` gives along
  each pass.
- The kernel wrapper's dimensions and output views (the C entry replaced
  by a recorder), the refusals, no launch on the CPU, and a
  `vcf.dwt.bank` span a level inside the clip path's spans.

The kernels themselves run only on a card (`tests/test_torch_cuda.py`).
"""

import json

import numpy as np
import pytest
import torch

from vcf_tpu_torch import Codec, CodecConfig
from vcf_tpu_torch.io import test_image as make_image
from vcf_tpu_torch.ops import dwt
from vcf_tpu_torch.ops.cuda import _build
from vcf_tpu_torch.ops.cuda import dwt_kernel as dk
from vcf_tpu_torch.utils import profiling

# haar / db / sym / coif: one length and shift; bior2.2 = legall53 and
# bior4.4 = cdf97: lengths, shifts and phases apart; rbio3.5: phases apart
FAMILIES = ["haar", "db2", "db5", "sym4", "coif2", "bior2.2", "legall53",
            "bior4.4", "cdf97", "rbio3.5"]


def _signal(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random(shape) * 255 - 128)
                            .astype(np.float32))


def _chain_analysis(x, bank, axis):
    """One level as `ops.dwt` computed it before the wrappers."""
    cols = dwt._down_pair(dwt._down_pair(x, bank, axis), bank, axis + 2)
    return cols[0, 0], (cols[1, 0], cols[0, 1], cols[1, 1])


def _chain_synthesis(ll, details, bank, out_hw, axis):
    cols = dwt._up_pairs(torch.stack((ll,) + tuple(details)), bank, axis + 2,
                         out_hw[1])
    rows = dwt._up_pairs(cols[0::2] + cols[1::2], bank, axis + 1, out_hw[0])
    return rows[0] + rows[1]


def _shape(axis, n, hw, t):
    return ((n,) if axis == 1 else ()) + hw + (t,)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("name", FAMILIES)
def test_plain_route_is_the_torch_chain(name, axis):
    bank = dwt.get_bank(name)
    launches = (dk.analyze_level.launches, dk.synthesize_level.launches)
    seed = 0
    for n in ((1, 3) if axis == 1 else (1,)):
        for t in (1, 3):
            for hw in ((16, 24), (2, 4)):
                seed += 1
                x = _signal(_shape(axis, n, hw, t), seed)
                got = dwt.analyze_level(x, bank, axis)
                want = _chain_analysis(x, bank, axis)
                for g, w in zip((got[0],) + got[1], (want[0],) + want[1]):
                    assert g.shape == w.shape and g.stride() == w.stride()
                    assert torch.equal(g, w)
                y = dwt.synthesize_level(want[0], want[1], bank, hw, axis)
                assert torch.equal(
                    y, _chain_synthesis(want[0], want[1], bank, hw, axis))
    # five levels down to 2 x 4, through ops.dwt's multilevel entries
    x = _signal(_shape(axis, 1, (64, 128), 3), 99)
    decomp = dwt.analyze(x, name, 5, axis)
    assert decomp[0].shape[axis:axis + 2] == (2, 4)
    cur, flat = x, []
    for _ in range(5):
        cur, d = _chain_analysis(cur, bank, axis)
        flat = list(d) + flat
    for g, w in zip([decomp[0]] + [b for d in decomp[1:] for b in d],
                    [cur] + flat):
        assert torch.equal(g, w)
    assert torch.equal(dwt.synthesize(decomp, name, axis),
                       dwt.synthesize_level_ref(
                           *_up_to_level_one(decomp, bank, axis), axis))
    assert (dk.analyze_level.launches, dk.synthesize_level.launches) == \
        launches


def _up_to_level_one(decomp, bank, axis):
    """The arguments of the last synthesis level, the coarser levels by
    the torch chain."""
    cur = decomp[0]
    for details in decomp[1:-1]:
        hw = tuple(2 * s for s in details[0].shape[axis:axis + 2])
        cur = _chain_synthesis(cur, details, bank, hw, axis)
    d = decomp[-1]
    return cur, d, bank, tuple(2 * s for s in d[0].shape[axis:axis + 2])


@pytest.mark.parametrize("name", FAMILIES)
def test_launch_arguments_follow_the_bank(name):
    bank = dwt.get_bank(name)
    for h, w in ((1088, 1920), (34, 60), (4, 2), (2, 8)):
        taps, ints = dwt.kernel_args(bank, h, w)
        assert taps == tuple(bank.dec_lo.tolist()) + tuple(
            bank.dec_hi.tolist())
        assert np.array_equal(np.float32(taps), np.concatenate(
            [bank.dec_lo, bank.dec_hi]))
        shifts = (bank.shift_lo, bank.shift_hi)
        fuse = [int(dwt._fuses_first(f[0], f[1], s % n == 0))
                for n in (h, w)
                for f, s in ((bank.dec_lo, shifts[0]),
                             (bank.dec_hi, shifts[1]))]
        assert ints == (len(bank.dec_lo), len(bank.dec_hi), *shifts, *fuse)
        taps, ints = dwt.kernel_args(bank, h, w, synthesis=True)
        assert taps == tuple(bank.rec_lo.tolist()) + tuple(
            bank.rec_hi.tolist())
        assert ints == (len(bank.rec_lo), len(bank.rec_hi), bank.phase_lo,
                        bank.phase_hi)


def test_fusing_follows_the_pass_length():
    """rbio3.x's lowpass shift -2 is a roll by 0 only on a pass of length
    2, its highpass shifts -4 .. -10 on passes whose length divides them:
    one bank fuses its first pairs apart at different level sizes, and the
    wrapper passes each pass's own flags."""
    rows = {n: dwt.kernel_args(dwt.get_bank("rbio3.7"), n, 16)[1][4:6]
            for n in (2, 4, 8, 16)}
    assert rows == {2: (0, 0), 4: (1, 0), 8: (1, 0), 16: (1, 1)}
    cols = dwt.kernel_args(dwt.get_bank("rbio3.5"), 16, 2)[1][6:]
    assert cols == (0, 0)
    assert dwt.kernel_args(dwt.get_bank("rbio3.5"), 16, 4)[1][6:] == (1, 1)


@pytest.mark.parametrize("axis", [0, 2])
def test_launch_route_dimensions_and_views(monkeypatch, axis):
    """The C entries replaced by a recorder: (B, H, W, T) from the axes
    before the rows and after the columns, the taps and eight ints of
    `kernel_args`, and the analysis views laid out as the plain version's;
    a CPU tensor is refused."""
    calls = []
    monkeypatch.setattr(dk, "_call",
                        lambda entry, dev, *args: calls.append((entry, args)))
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    bank = dwt.get_bank("bior4.4")
    lead, trail = ((), (3,)) if axis == 0 else ((2, 3), (3, 2))
    x = _signal(lead + (12, 20) + trail, 5)
    b, t = int(np.prod(lead)), int(np.prod(trail))
    monkeypatch.setattr(dk.analyze_level, "launches", 0)
    monkeypatch.setattr(dk.synthesize_level, "launches", 0)
    an_args = dwt.kernel_args(bank, 12, 20)
    sy_args = dwt.kernel_args(bank, 12, 20, synthesis=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        dk.analyze_level(x, *an_args, axis)
    monkeypatch.setattr(_build, "runs_plain", lambda t: False)
    ll, det = dk.analyze_level(x, *an_args, axis)
    want = dwt.analyze_level_ref(x, bank, axis)
    for g, w in zip((ll,) + det, (want[0],) + want[1]):
        assert g.shape == w.shape and g.stride() == w.stride()
    (entry, args), = calls
    assert entry == "vcf_dwt_analyze"
    taps, ints = an_args
    assert list(args[3]) == list(np.float32(taps))
    assert tuple(args[4]) == ints
    assert args[5:9] == (b, 12, 20, t)
    calls.clear()
    y = dk.synthesize_level((ll,) + det, *sy_args, axis)
    assert y.shape == x.shape and y.is_contiguous()
    (entry, args), = calls
    assert entry == "vcf_dwt_synthesize"
    taps, ints = sy_args
    assert list(args[6]) == list(np.float32(taps))
    assert tuple(args[7]) == ints
    assert args[8:12] == (b, 6, 10, t)
    assert (dk.analyze_level.launches, dk.synthesize_level.launches) == (1, 1)


def test_refusals():
    bank = dwt.get_bank("db5")
    x = _signal((8, 12, 3), 1)
    for bad in (x.double(), x.to(torch.uint8), x.half()):
        with pytest.raises(ValueError, match="float32"):
            dwt.analyze_level(bad, bank)
    for shape, axis in (((7, 12, 3), 0), ((8, 13), 0), ((2, 5, 12, 3), 1)):
        with pytest.raises(ValueError, match="odd length"):
            dwt.analyze_level(_signal(shape, 2), bank, axis)
    with pytest.raises(ValueError, match="no rows"):
        dwt.analyze_level(_signal((8,), 3), bank)
    ll, det = dwt.analyze_level(x, bank)
    with pytest.raises(ValueError, match="float32"):
        dwt.synthesize_level(ll.double(), det, bank, (8, 12))
    with pytest.raises(ValueError, match="odd length"):
        dwt.synthesize_level(ll, det, bank, (7, 12))
    with pytest.raises(ValueError, match="one shape"):
        dwt.synthesize_level(ll, det[:2], bank, (8, 12))
    with pytest.raises(ValueError, match="one shape"):
        dwt.synthesize_level(ll, (det[0], det[1], det[2][:1]), bank, (8, 12))


def test_no_launch_on_the_cpu():
    codec = Codec(CodecConfig(spatial="dwt", entropy="cgrans"), device="cpu")
    clip = torch.from_numpy(np.stack([make_image(64, 128, seed=s)
                                      for s in (1, 2)]))
    before = (dk.analyze_level.launches, dk.synthesize_level.launches)
    lanes = codec._dwt.clip_to_lanes(codec, clip)
    codec._dwt.lanes_to_clip(codec, lanes, clip.shape[1:])
    assert (dk.analyze_level.launches, dk.synthesize_level.launches) == before


def test_bank_span_a_level_inside_the_clip_spans(tmp_path):
    codec = Codec(CodecConfig(spatial="dwt", entropy="cgrans"), device="cpu")
    clip = torch.from_numpy(np.stack([make_image(64, 128, seed=4)]))
    with profiling.trace(str(tmp_path)):
        lanes = codec._dwt.clip_to_lanes(codec, clip)
        codec._dwt.lanes_to_clip(codec, lanes, clip.shape[1:])
    with open(tmp_path / "trace.json") as f:
        spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                       for e in json.load(f)["traceEvents"]
                       if e.get("cat") == "user_annotation" and "dur" in e
                       and e["name"].startswith("vcf.dwt."))
    outer = {n: (a, b) for a, b, n in spans if n in ("vcf.dwt.analyze",
                                                     "vcf.dwt.synthesize")}
    banks = [(a, b) for a, b, n in spans if n == "vcf.dwt.bank"]
    levels = codec._dwt.levels
    assert len(banks) == 2 * levels
    for name, part in (("vcf.dwt.analyze", banks[:levels]),
                       ("vcf.dwt.synthesize", banks[levels:])):
        a0, b0 = outer[name]
        assert all(a0 <= a and b <= b0 for a, b in part)
