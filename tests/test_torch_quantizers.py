"""The port's quantizers (Lloyd-Max, block VQ, palette VQ), its numpy
threefry draws, the quantizer flows of `Codec` and the Lloyd-Max
`BatchCodec` / `IIICodec`, against vcf_tpu's.

Tolerances, each with its reason:
* `prng` bits, `randint`, `uniform`: exact (integer operations and one
  mantissa trick);
* `prng.categorical`: equal on every key, save at most one draw, and
  that only where the top two perturbed logits lie within 4 ulp: the
  Gumbel noise takes a float32 log, which is not correctly rounded in
  XLA, so it may differ from vcf_tpu's in its last bit (ROADMAP C2);
* Lloyd-Max levels from the same integer input: bit-identical (every
  sum is an integer, exact in float64 and, at these sizes, in vcf_tpu's
  float32);
* Lloyd-Max through the whole codec: with ycocg the same stream bytes
  (its DCT takes vcf_tpu's CPU float order, `ops.dct.analyze_xla`); with
  ycrcb, whose colour dot the port evaluates in another order, indexes
  within 1 of vcf_tpu's on at most 1% of entries: the levels are trained
  on round(coefficient), a tipped .5 tie moves a histogram count, a level,
  and every value between its old and new bound (575 of 196,608 at
  256x256 before the DCT took XLA's order);
* palette VQ (integer pixels): centres and labels bit-identical;
* block VQ on the same blocks: seeding bit-identical, labels equal,
  centres within 1e-5 relative (their sums are not integers: float32 in
  vcf_tpu, float64 here);
* streams of flows without a DCT: byte-identical;
* decoded frames through a DCT from one stream: d.max() <= 1 and
  (d != 0).mean() < 1e-3 (the inverse DCT's float order, C1;
  tests/test_parallel.py's rule).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import vcf_tpu
from vcf_tpu.io import test_image as make_test_image
from vcf_tpu.io.video import test_video as make_test_video
from vcf_tpu.ops import dct as jdct
from vcf_tpu.ops import quantize as jq
from vcf_tpu.ops import vq as jvq
from vcf_tpu.parallel import mesh as jmesh
from vcf_tpu_torch import Codec, CodecConfig, CodeStream, video
from vcf_tpu_torch.config import VideoConfig
from vcf_tpu_torch.ops import prng
from vcf_tpu_torch.ops import quantize as tq
from vcf_tpu_torch.ops import vq as tvq
from vcf_tpu_torch.parallel import BatchCodec

LLOYD_DIFF_SHARE = 1e-2


def _pair(**kw):
    return (Codec(CodecConfig(**kw), device="cpu"),
            vcf_tpu.Codec(vcf_tpu.CodecConfig(**kw)))


def _pixel_rule(got, want):
    d = np.abs(np.asarray(got).astype(np.int64) - np.asarray(want))
    assert d.max() <= 1 and (d != 0).mean() < 1e-3


def _jax_coeff(img, **kw):
    """vcf_tpu's DCT coefficients of `img` under config `kw`."""
    jc = vcf_tpu.Codec(vcf_tpu.CodecConfig(**kw))
    return np.asarray(jc._analyze(jdct.pad_centered(
        jnp.asarray(img, jnp.float32), 8)))


# ---------------------------------------------------------------------------
# threefry draws
# ---------------------------------------------------------------------------

KEYS = [0, 1, 2, 7, 42, 12345, 2 ** 31 - 1, -3] + list(range(100, 142))


def test_prng_bits_randint_uniform_equal_jax():
    assert len(KEYS) == 50
    for seed in KEYS:
        kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        np.testing.assert_array_equal(np.asarray(kj), kt)
        np.testing.assert_array_equal(np.asarray(jax.random.split(kj, 3)),
                                      prng.split(kt, 3))
        np.testing.assert_array_equal(
            np.asarray(jax.random.bits(kj, (5, 7))),
            prng.random_bits(kt, (5, 7)))
        for n in (1, 7, 10752, 16384, 2 ** 20 + 3):
            assert int(jax.random.randint(kj, (), 0, n)) == int(
                prng.randint(kt, (), 0, n))
        np.testing.assert_array_equal(
            np.asarray(jax.random.randint(kj, (9,), -5, 300)),
            prng.randint(kt, (9,), -5, 300))
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(kj, (257,))),
            prng.uniform(kt, (257,)))


def test_prng_gumbel_within_ulps_of_jax():
    kj, kt = jax.random.PRNGKey(3), prng.PRNGKey(3)
    g_j = np.asarray(jax.random.gumbel(kj, (20000,)))
    g_t = prng.gumbel(kt, (20000,))
    # a last-bit difference of either log: near g = 0 the outer log's
    # argument is near 1, whose ulp bounds the difference
    ulp = np.spacing(np.maximum(np.abs(g_j), np.float32(1)))
    assert np.all(np.abs(g_t - g_j) <= 2 * ulp)
    assert np.count_nonzero(g_t != g_j) < 0.3 * g_j.size


def test_prng_categorical_equals_jax_on_kmeans_logits():
    """200 keys on k-means++-shaped logits: log of D^2 / sum(D^2), with
    zeros (already-chosen points) floored at 1e-30."""
    rng = np.random.default_rng(0)
    d2 = (rng.integers(0, 256, (3000, 3)).astype(np.float32)
          - np.float32(128)) ** 2
    d2 = d2.sum(axis=1)
    d2[rng.integers(0, 3000, 40)] = 0
    probs = d2 / np.float32(d2.astype(np.float64).sum())
    logits = np.log(np.maximum(probs, np.float32(1e-30))).astype(np.float32)
    cat = jax.jit(jax.random.categorical)
    differ = []
    for seed in range(200):
        kt = prng.split(prng.PRNGKey(seed))[1]
        kj = jax.random.split(jax.random.PRNGKey(seed))[1]
        i_t, i_j = prng.categorical(kt, logits), int(cat(kj, logits))
        if i_t != i_j:
            z = np.sort(prng.gumbel(kt, logits.shape) + logits)
            differ.append((seed, float(z[-1] - z[-2]),
                           float(np.spacing(np.float32(z[-1])))))
    assert len(differ) <= 1, differ
    for _, gap, ulp in differ:
        assert gap <= 4 * ulp


# ---------------------------------------------------------------------------
# Lloyd-Max
# ---------------------------------------------------------------------------

def test_lloydmax_levels_bit_identical_on_the_same_input():
    """At the golden's 96x112 on vcf_tpu's rounded coefficients: levels,
    histogram and indexes; also past the uint8 wrap (qss 8: 512 levels)."""
    img = make_test_image(96, 112, seed=5)
    coeff = _jax_coeff(img, quantizer="lloydmax")
    x = np.round(coeff).astype(np.int32)
    for qss in (32, 8):
        lj = np.asarray(jq.lloydmax_train(jnp.asarray(x), qss, -2048, 2047))
        lt = tq.lloydmax_train(torch.from_numpy(x), qss, -2048, 2047)
        np.testing.assert_array_equal(lt.numpy(), lj)
        np.testing.assert_array_equal(
            tq.lloydmax_histogram(torch.from_numpy(x), -2048, 2047).numpy(),
            np.asarray(jq.lloydmax_histogram(jnp.asarray(x), -2048, 2047)))
        kj = np.asarray(jq.lloydmax_quantize(jnp.asarray(coeff),
                                             jnp.asarray(lj)))
        kt = tq.lloydmax_quantize(torch.from_numpy(coeff), lt)
        np.testing.assert_array_equal(kt.numpy(), kj)
        np.testing.assert_array_equal(
            tq.lloydmax_dequantize(kt, lt).numpy(),
            np.asarray(jq.lloydmax_dequantize(jnp.asarray(kj),
                                              jnp.asarray(lj))))


def test_lloydmax_sums_exact_past_float32():
    """Counts whose moments pass 2^24: the levels are the float32 quotient
    of the exact (float64) sums, for any order of summation."""
    rng = np.random.default_rng(1)
    hist = rng.integers(0, 3_000_000, (2, 4096)).astype(np.int64)
    levels = tq.lloydmax_train_from_hist(torch.from_numpy(hist), 32, -2048,
                                         2047, iters=1)
    init = tq._init_levels(128, -2048, 2047)
    bounds = np.float32(0.5) * (init[1:] + init[:-1])
    support = np.arange(-2048, 2048, dtype=np.float32)
    assign = (support[:, None] >= bounds[None, :]).sum(axis=1)
    for ch in range(2):
        w = hist[ch] + 1
        mass = np.bincount(assign, weights=w.astype(np.float64),
                           minlength=128)
        moment = np.bincount(assign, weights=(w * support.astype(np.int64))
                             .astype(np.float64), minlength=128)
        want = np.float32(moment.astype(np.float32)
                          / mass.astype(np.float32))
        np.testing.assert_array_equal(levels[ch].numpy(), want)
    assert np.abs(levels.numpy()).max() < 2048


@pytest.mark.parametrize("kw", [dict(), dict(qss=8), dict(color="ycrcb")])
def test_lloydmax_codec_indexes_within_one_of_vcf_tpu(kw):
    img = make_test_image(256, 256, seed=1)
    tc, jc = _pair(quantizer="lloydmax", entropy="zlib", **kw)
    cs_t, cs_j = tc.encode(img), jc.encode(img)
    # indexes before the uint8 wrap: quantize each package's coefficients
    # with its own stored levels
    x = tq.lloydmax_quantize(
        tc._analyze(torch.from_numpy(img).to(torch.float32)),
        torch.from_numpy(cs_t.get_array("q_levels"))).numpy()
    k_j = np.asarray(jq.lloydmax_quantize(
        jnp.asarray(_jax_coeff(img, quantizer="lloydmax", **kw)),
        jnp.asarray(cs_j.get_array("q_levels"))))
    d = np.abs(x.astype(np.int64) - k_j)
    assert d.max() <= 1
    assert np.count_nonzero(d) <= LLOYD_DIFF_SHARE * d.size
    stored, _ = tc._load_indexes(cs_t, 0, True)
    np.testing.assert_array_equal(stored, x.astype(np.uint8))
    if "color" not in kw:
        assert cs_t.to_bytes() == cs_j.to_bytes()
    # each decodes the other's stream as its own package does
    _pixel_rule(tc.decode(cs_j), np.asarray(jc.decode(cs_j)))


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,k", [(1, 32), (3, 64)])
def test_palette_kmeans_bit_identical(seed, k):
    px = make_test_image(96, 112, seed=5).reshape(-1, 3).astype(np.float32)
    cj, lj = jvq.kmeans(jax.random.PRNGKey(seed), jnp.asarray(px), k)
    ct, lt = tvq.kmeans(prng.PRNGKey(seed), torch.from_numpy(px), k)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))


def test_palette_kmeans_seeds_on_the_stride_subsample():
    px = make_test_image(160, 130, seed=2).reshape(-1, 3).astype(np.float32)
    assert px.shape[0] > tvq.SEED_POINTS
    ij = jvq.kmeans_plus_plus_init(jax.random.PRNGKey(4), jnp.asarray(px), 8)
    it = tvq.kmeans_plus_plus_init(prng.PRNGKey(4), torch.from_numpy(px), 8)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def test_block_kmeans_matches_vcf_tpu_on_the_same_blocks():
    img = make_test_image(96, 112, seed=5)
    blocks = np.asarray(jvq.image_to_blocks(
        jnp.asarray(_jax_coeff(img, quantizer="vq")), 4))
    tb = tvq.image_to_blocks(torch.from_numpy(
        _jax_coeff(img, quantizer="vq")), 4)
    np.testing.assert_array_equal(tb.numpy(), blocks)
    np.testing.assert_array_equal(
        tvq.blocks_to_image(tb, 96, 112, 4, 3).numpy(),
        _jax_coeff(img, quantizer="vq"))
    key = jax.random.PRNGKey(0)
    np.testing.assert_array_equal(
        tvq.kmeans_plus_plus_init(prng.PRNGKey(0), tb, 256).numpy(),
        np.asarray(jvq.kmeans_plus_plus_init(key, jnp.asarray(blocks), 256)))
    cj, lj = jvq.kmeans(key, jnp.asarray(blocks), 256)
    ct, lt = tvq.kmeans(prng.PRNGKey(0), tb, 256)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tvq.assign_labels(tb, ct).numpy(),
                                  lt.numpy())


def test_vq_codec_labels_equal_vcf_tpu():
    img = make_test_image(96, 112, seed=5)
    tc, jc = _pair(quantizer="vq", entropy="zlib")
    cs_t, cs_j = tc.encode(img), jc.encode(img)
    assert cs_t["payload"] == cs_j["payload"]          # the label map
    np.testing.assert_allclose(cs_t.get_array("q_codebook"),
                               cs_j.get_array("q_codebook"), rtol=1e-4,
                               atol=1e-3)
    _pixel_rule(tc.decode(cs_j), np.asarray(jc.decode(cs_j)))


# ---------------------------------------------------------------------------
# Codec flows
# ---------------------------------------------------------------------------

SAME_BYTES = {
    "color_ycocg_cbaac": dict(spatial="none", color="ycocg", qss=16,
                              entropy="cbaac"),
    "color_ycocg_r_none": dict(spatial="none", color="ycocg_r",
                               quantizer="none", entropy="zlib"),
    "color_ycocg_none": dict(spatial="none", color="ycocg",
                             quantizer="none", entropy="huffman"),
    "color_ycrcb_lloydmax": dict(spatial="none", color="ycrcb",
                                 quantizer="lloydmax", entropy="zlib"),
    "quant_deadzone": dict(spatial="none", color="none", qss=8,
                           entropy="huffman"),
    "quant_lloydmax": dict(spatial="none", color="none",
                           quantizer="lloydmax", entropy="cbahc"),
    "colorvq_png_u16": dict(spatial="none", color="none",
                            quantizer="colorvq", colorvq_clusters=300,
                            entropy="png"),
    "dwt_lloydmax": dict(spatial="dwt", quantizer="lloydmax", dwt_levels=2,
                         entropy="zlib"),
    "dwt_lloydmax_grans": dict(spatial="dwt", quantizer="lloydmax",
                               dwt_levels=2, entropy="grans"),
    "dwt_none": dict(spatial="dwt", quantizer="none", dwt_levels=2,
                     entropy="zlib"),
    "entropy_png": dict(spatial="none", color="none", quantizer="none",
                        entropy="png"),
    "entropy_pnm": dict(spatial="none", color="none", quantizer="none",
                        entropy="pnm"),
}


@pytest.mark.parametrize("name", sorted(SAME_BYTES))
def test_flow_streams_equal_vcf_tpu(name):
    img = make_test_image(64, 80, seed=2)
    tc, jc = _pair(**SAME_BYTES[name])
    cs_t, cs_j = tc.encode(img), jc.encode(img)
    assert cs_t.to_bytes() == cs_j.to_bytes()
    rec = tc.decode(CodeStream.from_bytes(cs_t.to_bytes()))
    np.testing.assert_array_equal(rec, np.asarray(jc.decode(cs_j)))


def test_dct_without_quantizer_wraps_as_vcf_tpu():
    """round(coefficient) + 0 stored through uint8 wraps (C4); the rounded
    coefficients agree save at .5 ties (C1)."""
    img = make_test_image(64, 80, seed=2)
    tc, jc = _pair(quantizer="none", entropy="zlib")
    k_t, _ = tc._load_indexes(tc.encode(img), 0, False)
    k_j, _ = jc._load_indexes(jc.encode(img), 0, False)
    d = (k_t - k_j) % 256
    d = np.minimum(d, 256 - d)
    assert d.max() <= 1 and np.count_nonzero(d) <= 1e-3 * d.size
    coeff = np.round(_jax_coeff(img, quantizer="none")).astype(np.int64)
    assert (coeff < 0).any()                     # the wrap is exercised
    cs_j = jc.encode(img)
    _pixel_rule(tc.decode(cs_j), np.asarray(jc.decode(cs_j)))


def test_dwt_vq_decodes_where_vcf_tpu_raises():
    """DWT + VQ: the label maps and per-band codebooks are vcf_tpu's; its
    decode fails on the 2-D label shape, the port's decodes (C11)."""
    img = make_test_image(64, 64, seed=2)
    kw = dict(spatial="dwt", quantizer="vq", dwt_levels=2, vq_clusters=200,
              entropy="zlib")
    tc, jc = _pair(**kw)
    cs_t, cs_j = tc.encode(img), jc.encode(img)
    assert [n for n in cs_t] == [n for n in cs_j]
    for name in cs_t:
        if ".q_" not in name:
            assert cs_t[name] == cs_j[name], name
    with pytest.raises(IndexError):
        jc.decode(cs_j)
    rec = tc.decode(cs_j)
    assert rec.shape == img.shape
    assert np.abs(rec.astype(np.int64) - img).mean() < 16
    np.testing.assert_array_equal(tc.decode(cs_t), tc.decode(
        CodeStream.from_bytes(cs_t.to_bytes())))


# ---------------------------------------------------------------------------
# BatchCodec / IIICodec with Lloyd-Max
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def clip():
    return make_test_video(4, 48, 64)


LM = CodecConfig(quantizer="lloydmax", qss=32, entropy="zlib")


def test_batch_lloydmax_equals_per_frame_codec(clip):
    bc = BatchCodec(LM, "cpu")
    assert bc.route == "lloydmax"
    planes = bc.encode_planes(clip)
    levels = bc.last_qside["levels"]
    assert levels.shape == (4, 3, 128)
    rec = bc.decode_planes(planes, original_hw=clip.shape[1:3])
    for i, frame in enumerate(clip):
        codec = Codec(LM, "cpu")
        cs = codec.encode(frame)
        np.testing.assert_array_equal(cs.get_array("q_levels"), levels[i])
        k, _ = codec._load_indexes(cs, 0, True)
        np.testing.assert_array_equal(k.astype(np.uint8), planes[i])
        np.testing.assert_array_equal(rec[i], codec.decode(cs))


def test_batch_lloydmax_shared_levels(clip):
    bc = BatchCodec(LM, "cpu", shared_levels=True)
    planes = bc.encode_planes(clip)
    levels = bc.last_qside["levels"]
    coeff = torch.stack([Codec(LM, "cpu")._analyze(torch.from_numpy(f).to(
        torch.float32)) for f in clip])
    hist = tq.lloydmax_histogram(torch.round(coeff).to(torch.int32)
                                 .reshape(-1, 3), LM.q_min, LM.q_max)
    want = tq.lloydmax_train_from_hist(hist, LM.qss, LM.q_min, LM.q_max)
    np.testing.assert_array_equal(levels, want.numpy())
    np.testing.assert_array_equal(
        planes, tq.lloydmax_quantize(coeff, want).to(torch.uint8).numpy())
    # against vcf_tpu's psum'd histogram on one device: the trainers agree
    # on the same histogram
    np.testing.assert_array_equal(levels, np.asarray(
        jq.lloydmax_train_from_hist(jnp.asarray(hist.numpy()), LM.qss,
                                    LM.q_min, LM.q_max)))
    rec = bc.decode_planes(planes, original_hw=clip.shape[1:3])
    d = np.abs(rec.astype(np.int64) - clip)
    assert d.mean() < 8


def test_batch_lloydmax_against_vcf_tpu(clip):
    jb = jmesh.BatchCodec(vcf_tpu.CodecConfig(quantizer="lloydmax", qss=32,
                                              entropy="zlib"),
                          jmesh.make_mesh(1))
    pj = np.asarray(jb.encode_planes(clip))
    bc = BatchCodec(LM, "cpu")
    pt = bc.encode_planes(clip)
    d = np.abs(pt.astype(np.int64) - pj)
    assert d.max() <= 1 and np.count_nonzero(d) <= LLOYD_DIFF_SHARE * d.size
    rec_j = np.asarray(jb.decode_planes(pj, clip.shape[1:3]))
    rec_t = bc.decode_planes(pj, clip.shape[1:3],
                             qside={"levels": jb.last_qside["levels"]})
    e = np.abs(rec_t.astype(np.int64) - rec_j)
    assert e.max() <= 1 and (e != 0).mean() < 1e-3


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("entropy", ["zlib", "grans"])
def test_iii_lloydmax_clip(clip, shared, entropy):
    cfg = LM.replace(entropy=entropy)
    iii = video.IIICodec(VideoConfig(n_frames=4), cfg, "cpu",
                         shared_levels=shared)
    cs = iii.encode(clip)
    rec = iii.decode(CodeStream.from_bytes(cs.to_bytes()))
    bc = BatchCodec(cfg, "cpu", shared_levels=shared)
    np.testing.assert_array_equal(
        rec, bc.decode_planes(bc.encode_planes(clip), clip.shape[1:3]))
    if entropy == "zlib" and not shared:
        # the per-frame segments are the per-frame Codec's
        for i, frame in enumerate(clip):
            sub = Codec(cfg, "cpu").encode(frame)
            assert cs[f"f{i:04d}.payload"] == sub["payload"]
            assert cs[f"f{i:04d}.q_levels"] == sub["q_levels"]
