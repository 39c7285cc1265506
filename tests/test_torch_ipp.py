"""The port's IPPCodec (vcf_tpu_torch.video.ipp) against vcf_tpu's on the
CPU, at 96x112 and 64x128.

vcf_tpu on the CPU takes its XLA routes (full search, dynamic-slice
compensation, unfused DCT); the port takes, per `use_pallas`, its
kernels' plain versions (SAD, MC, B1/B2) or its torch route.

Tolerances, each with its reason:
* mv arrays and mode maps: equal (the port's float64 SADs are exact; a
  near-tie would be recorded in ROADMAP C6 — none occurs here);
* index planes: the ±1 rule of the closed loop — the float32 DCT sums of
  torch and XLA are taken in another order, so an index on a rounding
  edge may move by 1 (ROADMAP C1); in a P frame that moves the
  reconstruction and so the residuals after it in the GOP, hence a
  share of 0.05% rather than the still codec's 0.01% (observed: at most
  32 of 193,536, ROADMAP C7);
* streams: byte-identical whenever the index planes are equal (the
  entropy coders are exact);
* decoding: bit-exact — each package decodes the other's stream to the
  frames the other's decoder gives, and the port's decoder reproduces
  its encoder's closed-loop reconstruction;
* rmse: within 1e-2 of vcf_tpu's.
"""

import numpy as np
import pytest
import torch

import vcf_tpu
import vcf_tpu.video as jvideo
from vcf_tpu.io.video import test_video as make_test_video
from vcf_tpu_torch import CodecConfig, CodeStream, metrics, video
from vcf_tpu_torch.config import VideoConfig
from vcf_tpu_torch.ops.cuda import dct_kernel as dk
from vcf_tpu_torch.ops.cuda import mc_kernel as mk
from vcf_tpu_torch.ops.cuda import sad_kernel as sk
from vcf_tpu_torch.video import IPPCodec

MAX_DIFF_SHARE = 5e-4
MAX_RMSE_DIFF = 1e-2

# id -> (video kw, codec kw, (n, h, w))
CASES = {
    "zlib": (dict(gop_size=4), dict(qss=16, entropy="zlib"), (4, 96, 112)),
    "tiff": (dict(gop_size=4), dict(qss=16, entropy="tiff"), (4, 96, 112)),
    "grans": (dict(gop_size=4), dict(qss=32, entropy="grans"), (4, 96, 112)),
    "rdo": (dict(gop_size=4, rdo_lambda=0.5), dict(qss=32, entropy="zlib"),
            (4, 96, 112)),
    "three-step": (dict(gop_size=4, fast_search=True),
                   dict(qss=32, entropy="zlib"), (4, 96, 112)),
    "gop-padding": (dict(gop_size=4), dict(qss=16, entropy="zlib"),
                    (6, 96, 112)),
    "no-subbands": (dict(gop_size=4), dict(qss=32, entropy="zlib",
                                           subbands=False), (4, 96, 112)),
    "torch-route": (dict(gop_size=4), dict(qss=32, entropy="tiff",
                                           use_pallas=False), (4, 96, 112)),
    "grans-64x128-s4": (dict(gop_size=4, search_range=4),
                        dict(qss=32, entropy="grans"), (4, 64, 128)),
    "grans-torch-route": (dict(gop_size=4), dict(qss=16, entropy="grans",
                                                 use_pallas=False),
                          (4, 64, 128)),
    "all-intra": (dict(gop_size=1, rdo_lambda=0.5),
                  dict(qss=32, entropy="zlib"), (3, 64, 80)),
}
IDS = sorted(CASES)


def _planes(codec, cs, n):
    """The index planes of a stream, entropy-decoded."""
    if cs.get_json("payload")["batched"]:
        side = {k[len("clip."):]: cs[k] for k in cs
                if k.startswith("clip.") and k != "clip.payload"}
        return np.asarray(codec.entropy_codec.decode(cs["clip.payload"], side))
    return np.stack([
        codec.entropy_codec.decode(
            cs[f"f{i:04d}"], {k.split(".", 1)[1]: cs[k] for k in cs
                              if k.startswith(f"f{i:04d}.")})
        for i in range(n)])


@pytest.fixture(scope="module")
def runs():
    """Encode each case once with both packages; shared by the tests."""
    cache = {}

    def get(case):
        if case not in cache:
            vkw, ckw, (n, h, w) = CASES[case]
            frames = make_test_video(n, h, w)
            jc = jvideo.get(vcf_tpu.config.VideoConfig(mode="ipp", n_frames=n,
                                                       **vkw),
                            vcf_tpu.CodecConfig(**ckw))
            tc = video.get(VideoConfig(mode="ipp", n_frames=n, **vkw),
                           CodecConfig(**ckw), "cpu")
            cs_j = jc.encode(frames)
            cs_t = CodeStream.from_bytes(tc.encode(frames).to_bytes())
            cache[case] = dict(frames=frames, jc=jc, tc=tc, cs_j=cs_j,
                               cs_t=cs_t, rec_j=np.asarray(jc.decode(cs_j)))
        return cache[case]

    return get


def _streams_agree(cs_t, cs_j, tc, n):
    """The port's stream against vcf_tpu's: the same segments and
    payload, equal mvs and modes, index planes under the +-1 rule of the
    closed loop, and the same bytes where the planes are equal."""
    assert list(cs_t) == list(cs_j)
    assert cs_t.get_json("payload") == cs_j.get_json("payload")
    for name in cs_j:
        if name.startswith(("mv_", "modes_")):
            a, b = cs_t.get_array(name), cs_j.get_array(name)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b, err_msg=name)
    planes_t, planes_j = _planes(tc, cs_t, n), _planes(tc, cs_j, n)
    np.testing.assert_array_equal(planes_t, tc.last_planes)
    d = np.abs(planes_t.astype(np.int64) - planes_j)
    assert d.max() <= 1
    assert np.count_nonzero(d) <= MAX_DIFF_SHARE * d.size
    if not d.any():
        assert cs_t.to_bytes() == cs_j.to_bytes()


@pytest.mark.parametrize("case", IDS)
def test_ipp_streams_match_vcf_tpu(runs, case):
    r = runs(case)
    _streams_agree(r["cs_t"], r["cs_j"], r["tc"], len(r["frames"]))


@pytest.mark.parametrize("s", [30, 31])
def test_ipp_search_range_past_the_sad_gate(s):
    """ROADMAP C12: at m = 16 the SAD kernel's CPU gate takes s = 30 and
    refuses s = 31; `_make_search` then takes the full search by shape
    (vcf_tpu's "lax_full"), so the port encodes both, with vcf_tpu's
    stream under C7's rule.  The port's decoder gives its encoder's
    reconstruction; across packages the decodes follow the pixel rule
    (uniform noise frames put a pixel on a rounding edge of the inverse
    DCT's float32 sums: 1 of 36,864 differs by 1 at s = 31)."""
    frames = np.random.default_rng(s).integers(0, 256, (3, 64, 64, 3),
                                               dtype=np.uint8)
    kw = dict(mode="ipp", n_frames=3, gop_size=3, search_range=s)
    jc = jvideo.get(vcf_tpu.config.VideoConfig(**kw), vcf_tpu.CodecConfig())
    tc = video.get(VideoConfig(**kw), CodecConfig(), "cpu")
    kind = "sad_search" if s == 30 else "full_search"
    assert tc._make_search(64, 64).kind == kind
    assert sk.fits(16, s, "cpu") == (s == 30)
    cs_j = jc.encode(frames)
    cs_t = CodeStream.from_bytes(tc.encode(frames).to_bytes())
    _streams_agree(cs_t, cs_j, tc, 3)
    rec_t = tc.decode(cs_t)
    np.testing.assert_array_equal(rec_t.astype(np.float32),
                                  tc.last_recon.numpy())
    for got, want in ((tc.decode(cs_j), jc.decode(cs_j)),
                      (rec_t, jc.decode(cs_t))):
        d = np.abs(got.astype(np.int64) - np.asarray(want))
        assert d.max() <= 1 and (d != 0).mean() < 1e-3
    assert abs(metrics.rmse(frames, rec_t) - metrics.rmse(
        frames, np.asarray(jc.decode(cs_j)))) <= MAX_RMSE_DIFF


@pytest.mark.parametrize("case", IDS)
def test_ipp_decoders_agree_with_vcf_tpu(runs, case):
    """Each package decodes the other's stream to the frames the other's
    decoder gives, bit for bit; the port's decoder equals its encoder's
    closed-loop reconstruction; rmse within 1e-2 of vcf_tpu's."""
    r = runs(case)
    frames, jc, tc = r["frames"], r["jc"], r["tc"]
    rec_t = tc.decode(r["cs_t"])
    assert rec_t.dtype == np.uint8 and rec_t.shape == frames.shape
    np.testing.assert_array_equal(rec_t.astype(np.float32),
                                  tc.last_recon.numpy())
    np.testing.assert_array_equal(tc.decode(r["cs_j"]), r["rec_j"])
    np.testing.assert_array_equal(np.asarray(jc.decode(r["cs_t"])), rec_t)
    assert abs(metrics.rmse(frames, rec_t)
               - metrics.rmse(frames, r["rec_j"])) <= MAX_RMSE_DIFF


def test_ipp_routes():
    """`_make_search` tags its route; on the CPU every route runs plain
    torch, so no kernel launches."""
    kinds = {
        "sad_search": (VideoConfig(mode="ipp"), CodecConfig(), 96),
        "three_step": (VideoConfig(mode="ipp", fast_search=True),
                       CodecConfig(), 96),
        "full_search": (VideoConfig(mode="ipp"), CodecConfig(use_pallas=False),
                        96),
    }
    for kind, (vcfg, ccfg, h) in kinds.items():
        assert IPPCodec(vcfg, ccfg, "cpu")._make_search(h, 112).kind == kind
    codec = IPPCodec(VideoConfig(mode="ipp"), CodecConfig(), "cpu")
    assert codec._make_search(100, 112).kind == "full_search"
    # the planar grid loop exists for ycocg + deadzone only, as in vcf_tpu
    assert callable(codec._gop_encode_grid_batch)
    assert callable(codec._gop_decode_grid_batch)
    for color in ("none", "ycrcb"):
        other = IPPCodec(VideoConfig(mode="ipp"), CodecConfig(color=color),
                         "cpu")
        assert other._gop_encode_grid_batch is None
        assert other._gop_decode_grid_batch is None
    counters = (sk.sad_search, mk.mc_apply_planar, mk.mc_apply,
                dk.fused_dct_quantize, dk.fused_dequantize_idct)
    before = [f.launches for f in counters]
    frames = make_test_video(3, 32, 48)
    codec = video.get(VideoConfig(mode="ipp", n_frames=3, gop_size=3),
                      CodecConfig(), "cpu")
    codec.decode(codec.encode(frames))
    assert [f.launches for f in counters] == before


def test_video_get_returns_ipp_and_unported_loops_raise():
    """Every composition builds an IPPCodec: dct + deadzone takes the
    fused GOP loop, every other the generic closed loop through the still
    Codec, and a generic stream decodes.  (Until the generic loop was
    ported these compositions and streams raised, naming ROADMAP A10.)"""
    fused = video.get(VideoConfig(mode="ipp"), CodecConfig(), "cpu")
    assert isinstance(fused, IPPCodec) and fused.fused and fused.still is None
    for kw in (dict(spatial="dwt"), dict(quantizer="lloydmax")):
        codec = video.get(VideoConfig(mode="ipp"), CodecConfig(**kw), "cpu")
        assert isinstance(codec, IPPCodec) and not codec.fused
        assert codec.still.config == CodecConfig(**kw)
        assert codec._gop_encode_grid_batch is None
    frames = make_test_video(2, 32, 48)
    vcfg = VideoConfig(mode="ipp", n_frames=2, gop_size=2, search_range=2)
    generic = IPPCodec(vcfg, CodecConfig(spatial="dwt", dwt_levels=2,
                                         entropy="zlib"), "cpu")
    cs = CodeStream.from_bytes(generic.encode(frames).to_bytes())
    assert cs.get_json("payload")["generic"] is True
    rec = generic.decode(cs)
    assert rec.shape == frames.shape and rec.dtype == np.uint8
    np.testing.assert_array_equal(rec, generic.last_recon.numpy())
    with pytest.raises(ValueError, match="ME block"):
        IPPCodec(VideoConfig(mode="ipp", n_frames=2), CodecConfig(),
                 "cpu").encode(np.zeros((2, 40, 48, 3), np.uint8))


# id -> codec kw of the generic closed loop (vcf_tpu's tests/test_video.py
# TestIPPGeneric: 4 frames, gop 2, search range 4)
GENERIC = {
    "dwt": dict(spatial="dwt", qss=16, dwt_levels=2, entropy="zlib"),
    "lloydmax-dct": dict(quantizer="lloydmax", entropy="zlib"),
    "klt": dict(spatial="klt", qss=16, entropy="zlib"),
}


@pytest.mark.parametrize("name", list(GENERIC))
def test_generic_ipp_matches_vcf_tpu(name):
    """The generic loop's container against vcf_tpu's under C7's rule:
    the same segments, payload and mvs; the bytes equal where no index
    differs (DWT and Lloyd-Max: observed equal).  KLT trains its weights
    per frame, which may differ in float order (ROADMAP C3), so its
    stream may differ; each package decodes the other's stream to the
    frames the other's decoder gives, bit for bit."""
    frames = make_test_video(4, 96, 112)
    vkw = dict(mode="ipp", n_frames=4, gop_size=2, search_range=4)
    jc = jvideo.get(vcf_tpu.config.VideoConfig(**vkw),
                    vcf_tpu.CodecConfig(**GENERIC[name]))
    tc = video.get(VideoConfig(**vkw), CodecConfig(**GENERIC[name]), "cpu")
    assert not tc.fused and tc._make_search(96, 112).kind == "sad_search"
    cs_j = jc.encode(frames)
    cs_t = CodeStream.from_bytes(tc.encode(frames).to_bytes())
    assert list(cs_t) == list(cs_j)
    assert cs_t.get_json("payload") == cs_j.get_json("payload")
    for seg in cs_j:
        if seg.startswith("mv_"):
            a, b = cs_t.get_array(seg), cs_j.get_array(seg)
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b, err_msg=seg)
    if name != "klt":
        assert cs_t.to_bytes() == cs_j.to_bytes()
    rec_t = tc.decode(cs_t)
    np.testing.assert_array_equal(rec_t, tc.last_recon.numpy())
    np.testing.assert_array_equal(tc.decode(cs_j), np.asarray(jc.decode(cs_j)))
    np.testing.assert_array_equal(np.asarray(jc.decode(cs_t)), rec_t)
    assert metrics.rmse(frames, rec_t) < 12.0


def test_generic_ipp_search_range_past_the_sad_gate():
    """The generic loop searches through `_make_search`, so it routes by
    `sad_kernel.fits` as the fused loop does: past the CPU gate (m = 16,
    s = 31) the full search, with vcf_tpu's mvs and stream."""
    frames = make_test_video(2, 64, 64, seed=2)
    vkw = dict(mode="ipp", n_frames=2, gop_size=2, search_range=31)
    ckw = dict(spatial="dwt", qss=16, dwt_levels=2, entropy="zlib")
    tc = video.get(VideoConfig(**vkw), CodecConfig(**ckw), "cpu")
    assert not sk.fits(16, 31, "cpu")
    assert tc._make_search(64, 64).kind == "full_search"
    jc = jvideo.get(vcf_tpu.config.VideoConfig(**vkw),
                    vcf_tpu.CodecConfig(**ckw))
    cs_t = tc.encode(frames)
    assert cs_t.to_bytes() == jc.encode(frames).to_bytes()
    np.testing.assert_array_equal(tc.decode(cs_t), tc.last_recon.numpy())


def test_ipp_gop_batch_equals_single_gops():
    """GOPs are the batch dimension: coding two GOPs at once equals coding
    each alone."""
    frames = torch.from_numpy(make_test_video(6, 64, 80, seed=3))
    codec = IPPCodec(VideoConfig(mode="ipp", gop_size=3, search_range=4),
                     CodecConfig(qss=16), "cpu")
    both = codec._gop_encode(frames.reshape(2, 3, 64, 80, 3))
    for g in range(2):
        one = codec._gop_encode(frames[3 * g:3 * g + 3][None])
        for a, b in zip(both[:2] + both[3:], one[:2] + one[3:]):
            assert torch.equal(a[g], b[0])
