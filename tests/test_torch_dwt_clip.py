"""The DWT clip path (`ops.dwt.DWT.clip_to_lanes` / `lanes_to_clip`, the
frame-aware grid of `entropy.dwt_device`, `entropy.rans.
encode_lanes_device`) on the CPU.

- A clip's lanes and frames equal the one-frame path's (`_grid_bands`,
  `_synthesis`) frame by frame, bit for bit: the bank's chains are
  elementwise over the frame axis.
- The still codec, rebuilt on the clip entries with one frame, writes the
  same streams and decodes to the same pixels as before (sha256 of
  streams written by the one-frame path before it was rebuilt).
- The port keeps to the `dwt_wire_8f` cell's limits against the plain
  float64 reference (`portbench/reference/dwt.py`), and the reference's
  context decoder (`portbench/reference/rans_ctx.py`) decodes the port's
  context stream exactly.
- The clip path's spans open once a call, and `layout_bytes` counts its
  grid copies to the byte.
- The card's two ends (`ops.cuda.dwt_ends`) refuse CPU tensors, wrong
  dtypes and shapes before any launch, and launch nothing on a CPU clip;
  the dequantizer's stride mode; the forward colour kernel's FMA chain
  equals `fma_rows` on every u8 triple.
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.reference import dwt as rdwt
from portbench.reference import rans_ctx as rctx
from vcf_tpu_torch import Codec, CodecConfig, CodeStream
from vcf_tpu_torch.entropy import dwt_device as dd
from vcf_tpu_torch.entropy import rans
from vcf_tpu_torch.io import test_image as make_image
from vcf_tpu_torch.ops import color as color_ops
from vcf_tpu_torch.ops import dwt as tdwt
from vcf_tpu_torch.ops.cuda import _build, rans_ctx
from vcf_tpu_torch.ops.cuda import dwt_ends as dwe
from vcf_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
LIMITS = json.loads((REPO / "portbench" / "workloads" / "dwt_wire_8f.json")
                    .read_text())["limits"]


def _codec(**kw):
    return Codec(CodecConfig(**{"spatial": "dwt", "entropy": "cgrans",
                                **kw}), device="cpu")


def _clip(n, h, w, seed=3):
    return np.stack([make_image(h, w, seed=seed + i) for i in range(n)])


@pytest.mark.parametrize("hw", [(64, 128), (60, 100)])
@pytest.mark.parametrize("n", [1, 3])
def test_clip_entries_equal_the_one_frame_path(n, hw):
    codec = _codec()
    dwt = codec._dwt
    clip = _clip(n, *hw)
    shape = clip.shape[1:]
    sizes = dwt._grid_sizes(shape)
    sg, l = dd.grid_dims(sizes)
    g = len(sizes)
    lanes = dwt.clip_to_lanes(codec, torch.from_numpy(clip))
    assert lanes.shape == (g * sg * n, l) and lanes.dtype == torch.uint8
    blocks = lanes.view(g, n, sg * l)
    frames = dwt.lanes_to_clip(codec, lanes, shape)
    assert frames.shape == clip.shape and frames.dtype == torch.uint8
    for i, img in enumerate(clip):
        one = dd.bands_to_grid(dwt._grid_bands(codec, img), sg, l)
        assert torch.equal(blocks[:, i], one.view(g, sg * l))
        flat = dwt._grid_flat(codec, dd.grid_to_bands(one, sizes, sg),
                              dwt._band_shapes(shape))
        assert np.array_equal(frames[i].numpy(),
                              dwt._synthesis(codec, flat, shape))


def _per_filter_level(x, bank, axis):
    """One analysis level, one `_down_axis` chain a filter and band."""
    lo = tdwt._down_axis(x, bank.dec_lo, bank.shift_lo, axis)
    hi = tdwt._down_axis(x, bank.dec_hi, bank.shift_hi, axis)
    col = axis + 1
    return (tdwt._down_axis(lo, bank.dec_lo, bank.shift_lo, col),
            (tdwt._down_axis(lo, bank.dec_hi, bank.shift_hi, col),
             tdwt._down_axis(hi, bank.dec_lo, bank.shift_lo, col),
             tdwt._down_axis(hi, bank.dec_hi, bank.shift_hi, col)))


def _per_filter_synthesis(ll, details, bank, axis):
    """One synthesis level, one `_up_axis` chain a filter and band."""
    lh, hl, hh = details
    col = axis + 1
    h, w = 2 * ll.shape[axis], 2 * ll.shape[col]
    lo = (tdwt._up_axis(ll, bank.rec_lo, bank.phase_lo, col, w)
          + tdwt._up_axis(lh, bank.rec_hi, bank.phase_hi, col, w))
    hi = (tdwt._up_axis(hl, bank.rec_lo, bank.phase_lo, col, w)
          + tdwt._up_axis(hh, bank.rec_hi, bank.phase_hi, col, w))
    return (tdwt._up_axis(lo, bank.rec_lo, bank.phase_lo, axis, h)
            + tdwt._up_axis(hi, bank.rec_hi, bank.phase_hi, axis, h))


# db5, sym5: one length, shift and phase; haar, coif2: first pairs that
# fuse apart; bior4.4: shifts apart, phases alike but lengths apart;
# bior1.3, rbio2.4: phases apart
@pytest.mark.parametrize("name", ["db5", "sym5", "haar", "coif2", "bior4.4",
                                  "bior1.3", "rbio2.4"])
def test_plain_level_is_one_chain_a_filter(name):
    bank = tdwt.get_bank(name)
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.random((2, 32, 48, 3)) * 255 - 128)
                         .astype(np.float32))
    ll, details = tdwt.analyze_level(x, bank, axis=1)
    want_ll, want_details = _per_filter_level(x, bank, 1)
    for got, want in zip((ll,) + details, (want_ll,) + want_details):
        assert torch.equal(got, want)
    assert torch.equal(tdwt.synthesize_level(ll, details, bank, (32, 48),
                                             axis=1),
                       _per_filter_synthesis(ll, details, bank, 1))


def test_one_frame_grid_is_bands_to_grid():
    codec = _codec()
    img = make_image(64, 128, seed=9)
    sg, l = dd.grid_dims(codec._dwt._grid_sizes(img.shape))
    want = dd.bands_to_grid(codec._dwt._grid_bands(codec, img), sg, l)
    got = codec._dwt.clip_to_lanes(codec, torch.from_numpy(img)[None])
    assert torch.equal(got, want)


#: (config, image (h, w, seed), context coding forced at this size) ->
#: sha256 of the stream and of its decode, written by the one-frame path
#: before the device path was rebuilt on the clip entries
STREAMS = {
    "cgrans4_ctx": (dict(context_classes=4), (64, 128, 11), True,
                    "01882345b17b5a3e507462fbef851907aab80ee83267e7e3d1c2598276aabc87",
                    "3ae4da920a2c117c297ed5683531effcb20e4ceb475b4db0b01bf73a15e177ba"),
    "cgrans15_ctx_padded": (dict(context_classes=15), (60, 100, 12), True,
                            "8638f3f482ce191492e7d2bcfc5b929a8d1a270a249e616a3e18854da0096340",
                            "ef1185230d96478163d35d3ed8f4183851c0656c30d4ffb87c8bc4c9919250b3"),
    "grans_l3_q16_padded": (dict(entropy="grans", dwt_levels=3, qss=16),
                            (70, 90, 13), False,
                            "84999c6db468e1aac354fc205e8584e8461745b4aec0b4f602b7e5ab490c31cb",
                            "c20c66a8f972d3c39a15d59cac241aa2780843a86962574173252bff04333581"),
    "cgrans_order0": (dict(), (64, 128, 14), False,
                      "44d010c902c225dc1e8a91f94c0c9c95785fb8ad06a362c0bf183c1f50c4af5d",
                      "5f6cb47cfcee335a800dbb71fbcfb4f2f50426ed65272a923cf08b7db4c4928e"),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_device_streams_unchanged(monkeypatch, name):
    kw, (h, w, seed), forced, want_stream, want_pixels = STREAMS[name]
    if forced:
        monkeypatch.setattr(tdwt, "CTX_MIN_SYMBOLS", 0)
    codec = _codec(**kw)
    blob = codec.encode(make_image(h, w, seed=seed)).to_bytes()
    assert hashlib.sha256(blob).hexdigest() == want_stream
    rec = codec.decode(CodeStream.from_bytes(blob))
    assert hashlib.sha256(np.ascontiguousarray(rec).tobytes()
                          ).hexdigest() == want_pixels


def test_port_keeps_to_the_cells_limits_against_the_reference():
    """At 2 x 64 x 128 the port reads 0 on every number; the limits are
    the cell's own, set at its size on the card."""
    codec = _codec()
    clip = torch.from_numpy(_clip(2, 64, 128, seed=21))
    lanes = codec._dwt.clip_to_lanes(codec, clip)
    ref = rdwt.forward_grid(clip, 32, 5)
    share, over1 = rdwt.index_diffs(lanes, ref, clip.shape[1:], 2, 5)
    assert share <= LIMITS["enc_index_diff_share"]
    assert over1 == LIMITS["enc_index_diff_over1"] == 0
    frames = codec._dwt.lanes_to_clip(codec, lanes, clip.shape[1:])
    want = rdwt.inverse_grid(lanes, clip.shape[1:], 2, 32, 5)
    differ = (frames != want).to(torch.float64).mean().item()
    assert differ <= LIMITS["dec_pixel_diff_share"]
    assert int(((frames.to(torch.int32) - want.to(torch.int32)).abs() > 1)
               .sum()) == 0


def test_reference_decodes_the_ports_context_stream():
    codec = _codec()
    clip = torch.from_numpy(_clip(2, 64, 128, seed=31))
    lanes = codec._dwt.clip_to_lanes(codec, clip)
    g = len(codec._dwt._grid_sizes(clip.shape[1:]))
    freqs, cums = dd.train_ctx_tables(lanes, g, 4)
    assert np.array_equal(freqs, rctx.tables(lanes, g, 4))
    words, n_words, counts, states = rans.encode_lanes_device(
        lanes, torch.from_numpy(freqs.astype(np.int64)),
        torch.from_numpy(cums.astype(np.int64)))
    n = int(n_words)
    decoded, errors = rctx.decode(
        words[:n].view(torch.int16).to(torch.int64) & 0xFFFF, states, freqs,
        lanes.shape[1], counts)
    assert errors == 0 and torch.equal(decoded, lanes)


def _span_counts(events):
    names = [e["name"] for e in events
             if e.get("cat") == "user_annotation" and "dur" in e]
    return {k: names.count(k) for k in set(names)}


def test_clip_spans_open_once_a_call_and_layout_bytes_count_the_copies(
        tmp_path):
    codec = _codec()
    dwt = codec._dwt
    clip = torch.from_numpy(_clip(2, 64, 128, seed=41))
    shape = clip.shape[1:]
    lanes0 = dwt.clip_to_lanes(codec, clip)
    g = len(dwt._grid_sizes(shape))
    fg, cg = (torch.from_numpy(t.astype(np.int64))
              for t in dd.train_ctx_tables(lanes0, g, 4))
    grid_bytes = lanes0.numel()
    real = 2 * sum(dwt._grid_sizes(shape))
    logs = []
    for call in ("encode", "decode"):
        with profiling.trace(str(tmp_path / call)):
            c0 = profiling.counts()["layout_bytes"]
            if call == "encode":
                lanes = dwt.clip_to_lanes(codec, clip)
                stream = rans.encode_lanes_device(lanes, fg, cg)
            else:
                words, n_words, counts, states = stream
                out = rans_ctx.rans_decode_ctx(
                    words[:int(n_words)], states, fg, cg, lanes.shape[1],
                    counts)
                frames = dwt.lanes_to_clip(codec, out, shape)
            logs.append(profiling.counts()["layout_bytes"] - c0)
        with open(tmp_path / call / "trace.json") as f:
            spans = _span_counts(json.load(f)["traceEvents"])
        want = ({"vcf.dwt.analyze": 1, "vcf.dwt.layout": 1,
                 "vcf.rans.encode": 1, "vcf.rans.compact": 1}
                if call == "encode" else
                {"vcf.rans.decode": 1, "vcf.dwt.layout": 1,
                 "vcf.dwt.synthesize": 1})
        assert {k: spans.get(k, 0) for k in want} == want, spans
    assert torch.equal(out, lanes0)
    assert torch.equal(frames, dwt.lanes_to_clip(codec, lanes0, shape))
    # encode: the planes' symbols read, the grid written once; decode:
    # K3's transposed (S, L) view copied once, read and written
    assert logs == [real + grid_bytes, 2 * grid_bytes]


# The clip path's two ends as kernels (ops.cuda.dwt_ends): CUDA tensors
# only; a CPU clip takes the torch chains above.
ENDS = (dwe.color_in, dwe.bands_to_lanes, dwe.lanes_to_bands, dwe.color_out)


def _end_calls(frames, bands, lanes, x):
    """One call of each end's wrapper."""
    m = np.eye(3, dtype=np.float32)
    return {"color_in": lambda: dwe.color_in(frames, m, 128, 32),
            "bands_to_lanes": lambda: dwe.bands_to_lanes(bands, 32, 8, 16),
            "lanes_to_bands": lambda: dwe.lanes_to_bands(
                lanes, 32, [tuple(b.shape) for b in bands]),
            "color_out": lambda: dwe.color_out(x, m, 128, (30, 60))}


def _end_inputs():
    bands = [torch.zeros((2, 4, 8, 3)) for _ in range(4)]
    return (torch.zeros((2, 30, 60, 3), dtype=torch.uint8), bands,
            torch.zeros((5 * 8 * 2, 16), dtype=torch.uint8),
            torch.zeros((2, 32, 64, 3)))


@pytest.mark.parametrize("end", ["color_in", "bands_to_lanes",
                                 "lanes_to_bands", "color_out"])
def test_dwt_ends_refuse_cpu_tensors(end):
    before = [fn.launches for fn in ENDS]
    with pytest.raises(ValueError, match="CUDA tensors"):
        _end_calls(*_end_inputs())[end]()
    assert [fn.launches for fn in ENDS] == before


@pytest.mark.parametrize("end,args,what", [
    ("color_in", "float frames", "torch.uint8 input"),
    ("color_in", "4 channels", "3 channels"),
    ("color_in", "2-D frames", r"\(N, H, W\)"),
    ("bands_to_lanes", "float64 bands", "torch.float32 input"),
    ("bands_to_lanes", "L = 18", "multiple of 4"),
    ("lanes_to_bands", "int16 lanes", "torch.uint8 input"),
    ("lanes_to_bands", "41 lanes", "groups"),
    ("color_out", "u8 input", "torch.float32 input"),
    ("color_out", "1 channel", "3 channels"),
    ("color_out", "larger frames", "frames from")])
def test_dwt_ends_refuse_dtypes_and_shapes(monkeypatch, end, args, what):
    """Each wrapper checks its input before any launch (the C entries are
    not reached: no library is loaded here)."""
    monkeypatch.setattr(_build, "runs_plain", lambda t: False)
    monkeypatch.setattr(_build, "load", lambda: pytest.fail("launched"))
    frames, bands, lanes, x = _end_inputs()
    m = np.eye(3, dtype=np.float32)
    calls = {
        "float frames": lambda: dwe.color_in(frames.float(), m, 128, 32),
        "4 channels": lambda: dwe.color_in(
            torch.zeros((2, 30, 60, 4), dtype=torch.uint8), m, 128, 32),
        "2-D frames": lambda: dwe.color_in(frames[0, :, :, 0], None, 128,
                                           32),
        "float64 bands": lambda: dwe.bands_to_lanes(
            [b.double() for b in bands], 32, 8, 16),
        "L = 18": lambda: dwe.bands_to_lanes(bands, 32, 8, 18),
        "int16 lanes": lambda: dwe.lanes_to_bands(
            lanes.to(torch.int16), 32, [tuple(b.shape) for b in bands]),
        "41 lanes": lambda: dwe.lanes_to_bands(
            lanes[:41], 32, [tuple(b.shape) for b in bands]),
        "u8 input": lambda: dwe.color_out(x.to(torch.uint8), m, 128,
                                          (30, 60)),
        "1 channel": lambda: dwe.color_out(x[..., :1], m, 128, (30, 60)),
        "larger frames": lambda: dwe.color_out(x, m, 128, (33, 60))}
    before = [fn.launches for fn in ENDS]
    with pytest.raises(ValueError, match=what):
        calls[args]()
    assert [fn.launches for fn in ENDS] == before


@pytest.mark.parametrize("layout,mode", [("contiguous", "lanes"),
                                         ("K3's transposed view", "steps"),
                                         ("rows of a wider buffer", "lanes")])
def test_dwt_dequantize_mode_follows_the_strides(layout, mode):
    """The dequantizer stages its tiles along the steps for K3's (S, L)
    view of an (L, S) buffer, along the lanes otherwise."""
    grid = {"contiguous": torch.zeros((40, 16), dtype=torch.uint8),
            "K3's transposed view": torch.zeros((16, 40),
                                                dtype=torch.uint8).t(),
            "rows of a wider buffer": torch.zeros((40, 20),
                                                  dtype=torch.uint8)[:, :16]
            }[layout]
    assert dwe.dequantize_mode(grid) == mode


def test_clip_path_launches_no_kernel_on_the_cpu():
    codec = _codec()
    clip = torch.from_numpy(_clip(2, 64, 128, seed=43))
    before = [fn.launches for fn in ENDS]
    lanes = codec._dwt.clip_to_lanes(codec, clip)
    codec._dwt.lanes_to_clip(codec, lanes.t().contiguous().t(),
                             clip.shape[1:])
    assert [fn.launches for fn in ENDS] == before


@pytest.mark.parametrize("color", ["ycocg", "ycrcb", "cdct"])
def test_color_in_chain_is_fma_rows_on_every_u8_triple(color):
    """The forward colour kernel's chain, fma(x2, m2, fma(x1, m1, x0 *
    m0)) in float32 (here `ops.dwt.fma32`, exact), equals `fma_rows`'
    float64 steps on every RGB triple less the offset 128: on these
    integers the float64 sums are exact."""
    m = color_ops.MATRICES[color][0]
    step = 1 << 22
    for start in range(0, 1 << 24, step):
        v = torch.arange(start, start + step, dtype=torch.int64)
        x = torch.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255],
                        -1).to(torch.float32) - 128
        want = color_ops.fma_rows(x, m)
        for r in range(3):
            z = x[:, 0] * float(m[r, 0])
            z = tdwt.fma32(x[:, 1], float(m[r, 1]), z)
            z = tdwt.fma32(x[:, 2], float(m[r, 2]), z)
            assert torch.equal(z.view(torch.int32),
                               want[:, r].contiguous().view(torch.int32))
