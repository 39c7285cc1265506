"""The plain reference against vcf_tpu_torch on the CPU, at small sizes:
layouts, transform, tables, both stream forms and the IPP closed loop."""

import types

import numpy as np
import pytest
import torch

from portbench.inputs import moving_video, rolled_image
from portbench.reference import compare, ipp as ripp, lanes as rlanes
from portbench.reference import rans as rrans, transform as rtransform

CFG = {"height": 64, "width": 128}


@pytest.fixture(scope="module")
def port():
    from vcf_tpu_torch.entropy import rans
    from vcf_tpu_torch.ops import color
    from vcf_tpu_torch.ops.cuda import dct_kernel, rans_encode
    return types.SimpleNamespace(rans=rans, color=color, dk=dct_kernel,
                                 re=rans_encode)


def _clip(frames=4, seed=5):
    return rolled_image.make({"frames": frames, "pool": 1}, CFG, seed,
                             "cpu")[0]


def test_lane_layout_matches_port(port):
    planes = torch.randint(0, 256, (4, 3, 64, 128), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    s = rlanes.pick_streams(planes.numel())
    assert s == port.rans.RANSCodec._pick_streams(planes.numel(), 65536)
    cw = rlanes.chunk_w(128)
    assert cw == port.dk._chunk_w(128, 8)
    theirs = port.rans.grid_lanes_lmajor(port.dk.to_grid(planes, 8), 8, s,
                                         cw=cw)
    ours = rlanes.lanes_of(planes, s)
    assert torch.equal(ours, theirs)
    assert torch.equal(rlanes.planes_of(ours, planes.shape), planes)


def test_transform_matches_port(port):
    pix = _clip().permute(0, 3, 1, 2)
    mf = port.dk.static_mat(port.color.YCOCG_FWD)
    mi = port.dk.static_mat(port.color.YCOCG_INV)
    k = port.dk.fused_cdct_quantize(pix, mf)
    ours = rtransform.forward(pix)
    assert compare.diff_over1(ours, k) == 0
    assert compare.diff_share(ours, k) <= 1e-4
    back = port.dk.fused_dequantize_cdct(k, mi)
    assert compare.diff_over1(rtransform.inverse(k), back) == 0
    assert compare.diff_share(rtransform.inverse(k), back) <= 1e-4


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -3.0000002], dtype=torch.float32)
    got = rtransform.round_tf32(x)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -3.0])
    assert torch.equal(got, want)


def test_quantize_freqs_matches_port(port):
    rng = np.random.default_rng(3)
    for counts in (rng.integers(0, 1000, 256), np.zeros(256, np.int64),
                   np.eye(256, dtype=np.int64)[7] * 10 ** 6,
                   rng.integers(0, 3, 256) * rng.integers(0, 10 ** 5, 256)):
        want = port.rans.quantize_freqs(counts, min_all=True)
        assert np.array_equal(rrans.quantize_freqs(counts), want)
        assert rrans.quantize_freqs(counts).sum() == 1 << 15


@pytest.fixture(scope="module")
def coded(port):
    planes = rtransform.forward(_clip(seed=9).permute(0, 3, 1, 2))
    s = rlanes.pick_streams(planes.numel())
    lanes = rlanes.lanes_of(planes, s)
    freqs, cums = port.rans.freqs_from_counts(
        port.rans.group_histograms(lanes.t(), 64).numpy())
    fg = torch.from_numpy(freqs.astype(np.int64))
    cg = torch.from_numpy(cums.astype(np.int64))
    return lanes, freqs, fg, cg


def test_tables_match_port(coded):
    lanes, freqs, _, _ = coded
    assert np.array_equal(rrans.tables(lanes), freqs)


def test_wire_stream_decodes(port, coded):
    lanes, freqs, fg, cg = coded
    rows, counts, states = port.re.rans_encode_rows(lanes.t(), fg, cg)
    words, n_words = port.re.assemble_stream(rows, counts)
    w = words[:int(n_words)].view(torch.int16).to(torch.int64) & 0xFFFF
    got, errors = rrans.decode(w, states, freqs, lanes.shape[0],
                               counts=counts)
    assert errors == 0 and torch.equal(got, lanes)
    w_bad = w.clone()
    w_bad[len(w) // 2] ^= 1
    _, errors = rrans.decode(w_bad, states, freqs, lanes.shape[0],
                             counts=counts)
    assert errors > 0
    _, errors = rrans.decode(w[:-1], states, freqs, lanes.shape[0])
    assert errors > 0


def test_raw_grid_decodes(port, coded):
    lanes, freqs, fg, cg = coded
    raw, states = port.re.rans_encode_grouped(lanes.t(), fg, cg)
    words, flags = rrans.compact_raw(raw)
    got, errors = rrans.decode(words, states, freqs, lanes.shape[0],
                               flags=flags)
    assert errors == 0 and torch.equal(got, lanes)
    bad = flags.clone()
    bad[0, 0] = ~bad[0, 0]
    _, errors = rrans.decode(words, states, freqs, lanes.shape[0], flags=bad)
    assert errors > 0


def test_ipp_closed_loop_matches_port():
    from vcf_tpu_torch import CodecConfig, VideoConfig, video
    from vcf_tpu_torch.ops.cuda import dct_kernel as dk

    clip = moving_video.make({"frames": 20, "pool": 1}, CFG, 4, "cpu")[0]
    gops = clip.reshape(2, 10, 64, 128, 3)
    ipp = video.get(VideoConfig(mode="ipp", n_frames=20, gop_size=10,
                                me_block=16, search_range=8),
                    CodecConfig(entropy="grans", subbands=False), "cpu")
    planes, mvs = ipp._gop_encode_grid_batch(gops)
    rec = ipp._gop_decode_grid_batch(planes, mvs)
    want_planes, want_mvs = ripp.encode(gops, 16, 8)
    assert torch.equal(mvs, want_mvs)
    assert compare.diff_share(dk.from_grid(planes, 8), want_planes) <= 1e-4
    want_rec = ripp.decode(dk.from_grid(planes, 8), mvs, 16)
    assert compare.diff_share(rec, want_rec) <= 1e-4
    assert (mvs != 0).any()
