"""The port's profiler hooks (vcf_tpu_torch.utils.profiling) on the CPU:
`trace` writes one Chrome trace of the block it wraps into its
directory, with the codec's `vcf.*` spans in it; `span` is one shared
no-op while no profiler runs and changes no output; the `layout_bytes`
counter adds exactly the bytes of the layout copies, and `host_syncs`
counts nothing on the CPU; `device_memory_stats` is empty without a
card."""

import json
import os

import numpy as np
import pytest
import torch

from vcf_tpu_torch import Codec, CodecConfig
from vcf_tpu_torch.io import test_image as make_test_image
from vcf_tpu_torch.utils import profiling


def test_trace_writes_a_chrome_trace_of_the_block(tmp_path):
    log_dir = str(tmp_path / "trace")
    codec = Codec(CodecConfig(entropy="zlib"), "cpu")
    with profiling.trace(log_dir) as d:
        assert d == log_dir
        rec = codec.decode(codec.encode(make_test_image(32, 48, seed=1)))
    assert rec.shape == (32, 48, 3) and rec.dtype == np.uint8
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)


def test_device_memory_stats_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.device_memory_stats() == {}


# ---------------------------------------------------------------------------
# The codec's own spans and counters
# ---------------------------------------------------------------------------

def _planar_ipp():
    """4 frames of 64x128 as one GOP, through the planar grid loop."""
    from vcf_tpu_torch import VideoConfig, video
    from vcf_tpu_torch.io import test_video

    frames = torch.from_numpy(test_video(4, 64, 128, seed=9))[None]
    codec = video.get(VideoConfig(mode="ipp", n_frames=4, gop_size=4,
                                  me_block=16, search_range=4),
                      CodecConfig(entropy="grans"), "cpu")
    return codec, frames


def _run_planar_ipp(codec, frames):
    planes, mvs = codec._gop_encode_grid_batch(frames)
    return planes, mvs, codec.last_grid_recon, codec._gop_decode_grid_batch(
        planes, mvs)


def _lanes_case():
    """(2, 3, 64, 256) grid-layout planes cut into 1024 lanes of 96 steps:
    (b, s_streams, cw) for grid_lanes_lmajor."""
    planes = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, size=(2, 3, 64, 256), dtype=np.uint8))
    return planes, 8, 1024, 128


def _spans(events):
    """name -> [(start, end)] of the trace's `vcf.*` spans."""
    out = {}
    for e in events:
        if (e.get("cat") == "user_annotation"
                and e.get("name", "").startswith("vcf.")):
            out.setdefault(e["name"], []).append((e["ts"],
                                                  e["ts"] + e["dur"]))
    return out


def test_span_without_a_profiler_is_one_shared_no_op():
    assert not torch.autograd._profiler_enabled()
    first = profiling.span("vcf.ipp.luma")
    assert profiling.span("vcf.rans.sync") is first
    with first:
        pass
    assert profiling.span("vcf.dct.layout") is first


def test_count_takes_only_the_two_counters():
    before = profiling.counts()
    assert set(before) == {"layout_bytes", "host_syncs"}
    with pytest.raises(KeyError, match="no counter"):
        profiling.count("launches")
    assert profiling.counts() == before


def test_trace_holds_the_ipp_loop_and_lane_spans(tmp_path):
    from vcf_tpu_torch.entropy import rans

    codec, frames = _planar_ipp()
    planes, b, s, cw = _lanes_case()
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir):
        _run_planar_ipp(codec, frames)
        lanes = rans.grid_lanes_lmajor(planes, b, s, cw=cw)
        rans.grid_unlanes_lmajor(lanes.contiguous(), b, planes.shape, cw=cw)
    with open(os.path.join(log_dir, "trace.json")) as f:
        spans = _spans(json.load(f)["traceEvents"])
    for name in ("vcf.ipp.encode", "vcf.ipp.decode", "vcf.ipp.luma",
                 "vcf.ipp.pixels", "vcf.ipp.layout", "vcf.rans.layout",
                 "vcf.motion.search", "vcf.motion.compensate"):
        assert name in spans, name
    # two lumas a P step, in one span; three P steps
    assert len(spans["vcf.ipp.luma"]) == 3
    (enc0, enc1), = spans["vcf.ipp.encode"]
    assert all(enc0 <= a and b <= enc1 for a, b in spans["vcf.ipp.luma"])
    (dec0, _), = spans["vcf.ipp.decode"]
    assert dec0 >= enc1
    # the lane functions' spans follow the loop's
    assert len([1 for a, _ in spans["vcf.rans.layout"] if a >= dec0]) == 2


def test_loop_outputs_equal_with_and_without_a_profiler():
    from torch.profiler import ProfilerActivity, profile

    codec, frames = _planar_ipp()
    plain = _run_planar_ipp(codec, frames)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _run_planar_ipp(codec, frames)
    for a, b in zip(plain, traced):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_layout_bytes_count_the_copies():
    from vcf_tpu_torch.entropy import rans

    planes, b, s, cw = _lanes_case()
    n = planes.numel()
    c0 = profiling.counts()["layout_bytes"]
    lanes = rans.grid_lanes_lmajor(planes, b, s, cw=cw)
    # one transposing copy out of the planes; the (L, S) layout is a view
    c1 = profiling.counts()["layout_bytes"]
    assert c1 - c0 == 2 * n
    assert not lanes.is_contiguous()
    back = rans.grid_unlanes_lmajor(lanes.contiguous(), b, planes.shape,
                                    cw=cw)
    # two: the lanes regrouped by subband, then the tiles joined
    assert profiling.counts()["layout_bytes"] - c1 == 4 * n
    assert torch.equal(back, planes)

    codec, frames = _planar_ipp()
    c2 = profiling.counts()["layout_bytes"]
    planes_t, mvs = codec._gop_encode_grid_batch(frames)
    # the stacks of the index planes (u8) and of the reconstruction (f32)
    c3 = profiling.counts()["layout_bytes"]
    assert c3 - c2 == 2 * (planes_t.nbytes + codec.last_grid_recon.nbytes)
    rec = codec._gop_decode_grid_batch(planes_t, mvs)
    assert profiling.counts()["layout_bytes"] - c3 == 2 * rec.nbytes


def test_host_syncs_stay_zero_on_the_cpu():
    from vcf_tpu_torch.entropy import rans
    from vcf_tpu_torch.ops.cuda import rans_decode as rd
    from vcf_tpu_torch.ops.cuda import rans_encode as re_

    syms = torch.from_numpy(np.random.default_rng(5).integers(
        0, 7, size=(64, 12), dtype=np.uint8))
    fg, cg = (torch.from_numpy(t.astype(np.int64)) for t in
              rans.freqs_from_counts(rans.group_histograms(syms, 4).numpy()))
    before = profiling.counts()["host_syncs"]
    rows, counts, states = re_.rans_encode_rows(syms, fg, cg)
    words, n_words = re_.assemble_stream(rows, counts)
    raw, st = re_.rans_encode_grouped(syms, fg, cg)
    out = rd.rans_decode_grouped(words[:int(n_words)], states, fg, cg, 12,
                                 counts)
    assert torch.equal(out, syms)
    assert torch.equal(rd.rans_decode_grouped_grid(raw, st, fg, cg, 12), syms)
    codec, frames = _planar_ipp()
    _run_planar_ipp(codec, frames)
    assert profiling.counts()["host_syncs"] == before
