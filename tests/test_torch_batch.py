"""The port's BatchCodec and IIICodec (vcf_tpu_torch) against vcf_tpu's,
and the perceptual Codec flow.

Both vcf_tpu BatchCodec routes are held: XLA (use_pallas=False, or any
config on the CPU), and the color-fused Pallas kernels in interpret mode
under vcf_tpu.parallel.mesh._FORCE_FUSED_INTERPRET.  The port runs its
kernel routes on the CPU through the kernels' plain versions.

Tolerances, each with its reason:
* index planes: the +-1 rule — a float32 sum taken in another order (or
  a divide by qss against the kernels' multiply by float32(1/qss)) may
  move an index by 1, on at most 0.01% of entries;
* decoded frames from identical planes: d.max() <= 1 and
  (d != 0).mean() < 1e-3 (tests/test_parallel.py's rule);
* streams: byte-identical whenever the index planes are equal (the
  entropy coders are exact);
* rmse and bpp: 3 decimals.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import vcf_tpu
import vcf_tpu.video as jvideo
from vcf_tpu.io.video import test_video as jax_test_video
from vcf_tpu.parallel import mesh as jmesh
from vcf_tpu_torch import Codec, CodecConfig, CodeStream, metrics, video
from vcf_tpu_torch.config import VideoConfig
from vcf_tpu_torch.io import test_image as make_test_image
from vcf_tpu_torch.io import test_video as make_test_video
from vcf_tpu_torch.ops import dct as tdct
from vcf_tpu_torch.parallel import BatchCodec

MAX_DIFF_SHARE = 1e-4
CONFIGS = {"ycocg": dict(), "ycrcb": dict(color="ycrcb"),
           "cdct": dict(color="cdct"), "none": dict(color="none"),
           "perceptual": dict(perceptual=True)}


def _frames(n, h, w):
    return np.stack([make_test_image(h, w, seed=i) for i in range(n)])


def _index_rule(got, want):
    d = np.abs(np.asarray(got).astype(np.int64) - np.asarray(want))
    assert d.max() <= 1
    assert np.count_nonzero(d) <= MAX_DIFF_SHARE * d.size


def _pixel_rule(got, want):
    d = np.abs(np.asarray(got).astype(np.int64) - np.asarray(want))
    assert d.max() <= 1 and (d != 0).mean() < 1e-3


def _jax_batch(kw, fused=False):
    """vcf_tpu's BatchCodec on one device; fused=True forces its Pallas
    route in interpret mode (the color-fused kernels)."""
    cfg = vcf_tpu.CodecConfig(**kw)
    if not fused:
        return jmesh.BatchCodec(cfg.replace(use_pallas=False),
                                jmesh.make_mesh(1))
    jmesh._FORCE_FUSED_INTERPRET = True
    try:
        return jmesh.BatchCodec(cfg, jmesh.make_mesh(1))
    finally:
        jmesh._FORCE_FUSED_INTERPRET = False


def _jax_run(codec, frames):
    """encode_planes -> decode_planes of vcf_tpu's codec."""
    planes = np.array(codec.encode_planes(frames))
    return planes, np.array(codec.decode_planes(planes))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_batch_matches_vcf_tpu_xla_route(name, use_pallas):
    frames = _frames(2, 64, 128)
    kw = CONFIGS[name]
    planes_j, rec_j = _jax_run(_jax_batch(kw), frames)
    port = BatchCodec(CodecConfig(**kw, use_pallas=use_pallas), "cpu")
    planes_t = port.encode_planes(frames)
    _index_rule(planes_t, planes_j)
    _pixel_rule(port.decode_planes(planes_j), rec_j)


@pytest.mark.parametrize("color", ["ycocg", "ycrcb", "cdct"])
def test_batch_matches_vcf_tpu_fused_route(color):
    frames = _frames(2, 64, 128)
    kw = dict(color=color)
    planes_j, rec_j = _jax_run(_jax_batch(kw, fused=True), frames)
    port = BatchCodec(CodecConfig(**kw), "cpu")
    assert port.route == "cdct"
    _index_rule(port.encode_planes(frames), planes_j)
    _pixel_rule(port.decode_planes(planes_j), rec_j)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_batch_crops_odd_frames(use_pallas):
    """61x45 frames pad to 64x48; decode crops back to original_hw."""
    frames = _frames(3, 61, 45)
    planes_j = np.array(_jax_batch({}).encode_planes(frames))
    rec_j = np.array(_jax_batch({}).decode_planes(planes_j,
                                                  original_hw=(61, 45)))
    port = BatchCodec(CodecConfig(use_pallas=use_pallas), "cpu")
    planes_t = port.encode_planes(frames)
    assert planes_t.shape == (3, 64, 48, 3)
    _index_rule(planes_t, planes_j)
    rec_t = port.decode_planes(planes_j, original_hw=(61, 45))
    assert rec_t.shape == frames.shape
    _pixel_rule(rec_t, rec_j)


def test_batch_takes_any_strides():
    """Channel-planar and reversed frames code as their contiguous copy
    (the upload keeps numpy's strides instead of copying on the host)."""
    frames = _frames(2, 32, 48)
    planar = np.ascontiguousarray(frames.transpose(0, 3, 1, 2)
                                  ).transpose(0, 2, 3, 1)
    flipped = np.ascontiguousarray(frames[:, ::-1])[:, ::-1]
    port = BatchCodec(CodecConfig(), "cpu")
    want = port.encode_planes(frames)
    np.testing.assert_array_equal(port.encode_planes(planar), want)
    np.testing.assert_array_equal(port.encode_planes(flipped), want)
    np.testing.assert_array_equal(port.decode_planes(want[:, ::-1, ::-1]),
                                  port.decode_planes(want[:, ::-1, ::-1].copy()))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_batch_planes_equal_per_frame_codec(name):
    frames = _frames(3, 48, 64)
    cfg = CodecConfig(**CONFIGS[name])
    codec = Codec(cfg, device="cpu")
    per_frame = np.stack([
        torch.clamp(codec._quantize(codec._analyze(
            torch.from_numpy(f).to(torch.float32)))[0] + 128, 0, 255)
        .to(torch.uint8).numpy() for f in frames])
    np.testing.assert_array_equal(
        BatchCodec(cfg.replace(use_pallas=False), "cpu").encode_planes(frames),
        per_frame)
    _index_rule(BatchCodec(cfg, "cpu").encode_planes(frames), per_frame)


def test_routes_saturate_and_wrap_as_vcf_tpu():
    """At qss=1 the DC indexes leave [0, 255]: the kernel route clips
    them as vcf_tpu's fused kernels do, the torch route wraps them as
    vcf_tpu's XLA cast does (ROADMAP C4)."""
    frames = np.zeros((1, 32, 128, 3), np.uint8)
    frames[:, :, 64:] = 255
    kw = dict(qss=1)
    wrap_j, _ = _jax_run(_jax_batch(kw), frames)
    sat_j, _ = _jax_run(_jax_batch(kw, fused=True), frames)
    wrap_t = BatchCodec(CodecConfig(qss=1, use_pallas=False),
                        "cpu").encode_planes(frames)
    sat_t = BatchCodec(CodecConfig(qss=1), "cpu").encode_planes(frames)
    np.testing.assert_array_equal(wrap_t, wrap_j)
    np.testing.assert_array_equal(sat_t, sat_j)
    assert not np.array_equal(wrap_t, sat_t)


def test_batch_unported_flows_raise():
    assert BatchCodec(CodecConfig(quantizer="lloydmax"),
                      "cpu").route == "lloydmax"
    with pytest.raises(NotImplementedError, match="dct\\+deadzone"):
        BatchCodec(CodecConfig(spatial="dwt"), "cpu")


@pytest.mark.parametrize("kw", [
    dict(entropy="tiff"),                       # per-frame host segments
    dict(entropy="grans"),                      # one batched clip group
    dict(entropy="grans", perceptual=True),     # B1/B2 route
    dict(spatial="none", color="none", quantizer="none",
         entropy="tiff"),                       # per-frame Codec fallback
], ids=["tiff", "grans", "grans-perceptual", "entropy-only"])
def test_iii_matches_vcf_tpu(kw):
    frames = make_test_video(4, 96, 112)
    jc = jvideo.IIICodec(vcf_tpu.config.VideoConfig(n_frames=4),
                         vcf_tpu.CodecConfig(**kw))
    tc = video.get(VideoConfig(n_frames=4), CodecConfig(**kw), "cpu")
    cs_j, cs_t = jc.encode(frames), tc.encode(frames)
    meta = cs_t.get_json("payload")
    assert meta == cs_j.get_json("payload")
    if tc._batch is not None:
        planes_t = tc._batch.encode_planes(frames)
        planes_j = np.array(jc._batch.encode_planes(frames))
        _index_rule(planes_t, planes_j)
        if np.array_equal(planes_t, planes_j):
            assert cs_t.to_bytes() == cs_j.to_bytes()
    else:
        assert cs_t.to_bytes() == cs_j.to_bytes()
    rec_t = tc.decode(CodeStream.from_bytes(cs_t.to_bytes()))
    rec_j = np.asarray(jc.decode(cs_j))
    assert rec_t.shape == frames.shape
    _pixel_rule(rec_t, rec_j)
    # each decodes the other's stream
    _pixel_rule(tc.decode(cs_j), rec_j)


def test_iii_batched_stream_layout():
    frames = make_test_video(3, 64, 80)
    tc = video.get(VideoConfig(n_frames=3), CodecConfig(entropy="grans"),
                   "cpu")
    cs = tc.encode(frames)
    assert cs.get_json("payload")["batched"] is True
    assert "clip.payload" in cs and not any(n.startswith("f0") for n in cs)
    tiff = video.get(VideoConfig(n_frames=3), CodecConfig(), "cpu")
    with pytest.raises(ValueError, match="batched clip path"):
        video.get(VideoConfig(n_frames=3), CodecConfig(
            spatial="none", color="none", quantizer="none", entropy="grans"),
            "cpu").decode(cs)
    assert not tiff.encode(frames).get_json("payload")["batched"]
    assert isinstance(video.get(VideoConfig(mode="ipp"), CodecConfig(),
                                "cpu"), video.IPPCodec)


def test_test_video_and_video_config_equal_vcf_tpu():
    np.testing.assert_array_equal(make_test_video(3, 48, 64, seed=2),
                                  jax_test_video(3, 48, 64, seed=2))
    assert VideoConfig(gop_size=4).__dict__ == \
        vcf_tpu.config.VideoConfig(gop_size=4).__dict__
    with pytest.raises(ValueError):
        VideoConfig(mode="ibp")


@pytest.mark.parametrize("h,w", [(96, 112), (61, 45)])
def test_perceptual_codec_matches_vcf_tpu(h, w):
    img = make_test_image(h, w, seed=4)
    jc = vcf_tpu.Codec(vcf_tpu.CodecConfig(perceptual=True, entropy="grans"))
    tc = Codec(CodecConfig(perceptual=True, entropy="grans"), device="cpu")
    x = tdct.pad_centered(torch.from_numpy(img).to(torch.float32), 8)
    k_t = tc._quantize(tc._analyze(x))[0].numpy()
    k_j = np.asarray(jc._q(jc._analyze(
        jnp.asarray(tdct.pad_centered(torch.from_numpy(img), 8).numpy(),
                    jnp.float32))))
    _index_rule(k_t, k_j)
    cs_t, cs_j = tc.encode(img), jc.encode(img)
    if np.array_equal(k_t, k_j):
        assert cs_t.to_bytes() == cs_j.to_bytes()
    rec_t = tc.decode(CodeStream.from_bytes(cs_t.to_bytes()))
    rec_j = np.asarray(jc.decode(cs_j))
    assert abs(metrics.rmse(img, rec_t) - metrics.rmse(img, rec_j)) < 1e-3
    assert abs(metrics.bpp(cs_t, img.shape)
               - vcf_tpu.metrics.bpp(cs_j, img.shape)) < 1e-3
