"""The port's decode filters (vcf_tpu_torch.ops.filters) against
vcf_tpu's on the CPU, on 32x48 to 48x64 frames.

The rule, measured before it was set: the float32 outputs within 1e-3
absolute (the port's sums run in another order: separable taps, the NLM
box filter's conv, the DCTs inside BM3D; observed <= 2.2e-4), and as u8
after the round |d| <= 1 on at least 99.9% of pixels and never more than
2 (a float32 value on a .5 edge rounds either way; a BM3D coefficient on
the 2.7-sigma threshold may flip; observed: at most 1 pixel of 9,216
differs, by 1).  BM3D's block matching is reported: the share of blocks
whose selected displacements differ from vcf_tpu's N-pass argmin (its
distances are float32 sums in another order); on a frame of flat patches
the distances tie exactly, and the stable sort must pick as argmin does.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import vcf_tpu
from vcf_tpu.codestream import CodeStream as JCodeStream
from vcf_tpu.io import test_image as jax_test_image
from vcf_tpu.ops import filters as jfilters
from vcf_tpu_torch import Codec, CodecConfig, CodeStream
from vcf_tpu_torch.ops import filters as tfilters

MAX_F32_ERR = 1e-3
MAX_U8_DIFF, MAX_U8_SHARE = 2, 1e-3


def _noisy(h, w, seed, sigma=20.0):
    clean = jax_test_image(h, w, seed=seed).astype(np.float32)
    noise = np.random.default_rng(seed).normal(0, sigma, clean.shape)
    return np.clip(clean + noise, 0, 255).astype(np.uint8)


def _u8(x):
    return np.clip(np.round(np.asarray(x)), 0, 255).astype(np.uint8)


def _filter_rule(t_out, j_out):
    t_out, j_out = np.asarray(t_out), np.asarray(j_out)
    assert t_out.shape == j_out.shape and t_out.dtype == np.float32
    np.testing.assert_allclose(t_out, j_out, rtol=0, atol=MAX_F32_ERR)
    d = np.abs(_u8(t_out).astype(np.int64) - _u8(j_out))
    assert d.max() <= MAX_U8_DIFF
    assert np.count_nonzero(d > 1) <= MAX_U8_SHARE * d.size


def test_reflect_index_is_numpy_reflect():
    for n in (1, 2, 5, 9):
        for before, after in ((0, 0), (2, 3), (13, 13)):
            want = np.pad(np.arange(n), (before, after), mode="reflect")
            got = tfilters.reflect_index(n, before, after, "cpu").numpy()
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [3, 5, 7])
def test_gaussian_matches_vcf_tpu(size):
    img = _noisy(32, 48, seed=size)
    np.testing.assert_array_equal(tfilters.gaussian_kernel_1d(size),
                                  jfilters.gaussian_kernel_1d(size))
    _filter_rule(tfilters.gaussian_blur(torch.from_numpy(img), size),
                 jfilters.gaussian_blur(jnp.asarray(img), size))


@pytest.mark.parametrize("h,w,hh,template,search", [
    (32, 48, 10.0, 7, 7), (48, 64, 10.0, 7, 7), (32, 48, 4.0, 5, 7),
    (32, 48, 10.0, 7, 21)])
def test_nlm_matches_vcf_tpu(h, w, hh, template, search):
    img = _noisy(h, w, seed=h + search)
    _filter_rule(tfilters.nlm(torch.from_numpy(img), hh, template, search),
                 jfilters.nlm(jnp.asarray(img), hh, template, search))


@jax.jit
def _jax_selection(img, b=8, n_group=8, s=8):
    """vcf_tpu's block matching of the first phase of stage 1 (its code,
    vcf_tpu/ops/filters.py:159-177): (N, nby, nbx) indexes."""
    x = img.astype(jnp.float32)
    h, w, _ = x.shape
    nby, nbx = h // b, w // b
    luma = jnp.einsum("hwc,c->hw", x,
                      jnp.asarray([0.299, 0.587, 0.114], jnp.float32))
    disps = jnp.asarray(tfilters.displacements(s).astype(np.int32))

    def dist_body(_, d):
        shifted = jnp.roll(luma, (-d[0], -d[1]), (0, 1))
        return 0, ((luma - shifted) ** 2).reshape(nby, b, nbx, b).sum((1, 3))

    _, dvol = jax.lax.scan(dist_body, 0, disps)
    sel, dwork = [], dvol.at[0].set(-1.0)
    for _ in range(n_group):
        idx = jnp.argmin(dwork, axis=0)
        sel.append(idx)
        dwork = jnp.where(jnp.arange(disps.shape[0])[:, None, None]
                          == idx[None], jnp.inf, dwork)
    return jnp.stack(sel)


def _torch_selection(img, b=8, n_group=8, s=8):
    x = torch.from_numpy(np.asarray(img, np.float32))
    luma = tfilters.color_ops.fma_rows(
        x, tfilters.LUMA_WEIGHTS[None]).squeeze(-1)
    dvol = tfilters.block_distances(luma, tfilters.displacements(s), b)
    return tfilters.select_group(dvol, n_group).numpy()


@pytest.mark.parametrize("stages,h,w", [(1, 32, 48), (2, 32, 48),
                                         (2, 48, 64)])
def test_bm3d_matches_vcf_tpu(stages, h, w):
    img = _noisy(h, w, seed=stages + h)
    # stage 2 called as the Codec's filter calls it (one jit compile)
    kw = {} if stages == 2 else dict(stages=stages)
    _filter_rule(tfilters.bm3d(torch.from_numpy(img), 25.0, stages=stages),
                 jfilters.bm3d(jnp.asarray(img), 25.0, **kw))
    sel_t = _torch_selection(img)
    sel_j = np.asarray(_jax_selection(jnp.asarray(img)))
    share = float((sel_t != sel_j).any(0).mean())
    print(f"bm3d {h}x{w}: {share:.4f} of blocks select other displacements")
    assert (sel_t[0] == 0).all()                 # the block itself first
    assert share <= 0.05


@jax.jit
def _jax_argmin_passes(dvol, n_group=8):
    """vcf_tpu's top-N selection (vcf_tpu/ops/filters.py:171-177)."""
    sel, dwork = [], dvol.at[0].set(-1.0)
    for _ in range(n_group):
        idx = jnp.argmin(dwork, axis=0)
        sel.append(idx)
        dwork = jnp.where(jnp.arange(dvol.shape[0])[:, None, None]
                          == idx[None], jnp.inf, dwork)
    return jnp.stack(sel)


def test_bm3d_selection_on_exact_ties_is_argmins():
    """Distances that tie exactly (small integers: most of a block's 289
    displacements share a value), so the order among equal distances
    decides the group: the stable sort must keep the displacement order,
    as N first-minimum argmin passes do.  Then a frame of flat 8x8
    patches of four colours whose float32 lumas are all exactly 100, so
    that every distance of the matching is 0 in any summation order,
    through both selections and both filters."""
    dvol = np.random.default_rng(2).integers(0, 4, (289, 6, 8)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tfilters.select_group(torch.from_numpy(dvol), 8).numpy(),
        np.asarray(_jax_argmin_passes(jnp.asarray(dvol))))
    colours = np.array([[100, 100, 100], [0, 122, 249], [7, 133, 174],
                        [10, 154, 58]], np.uint8)
    patches = np.random.default_rng(3).integers(0, 4, (6, 8))
    img = np.repeat(np.repeat(colours[patches], 8, 0), 8, 1)
    sel_t = _torch_selection(img)
    np.testing.assert_array_equal(sel_t,
                                  np.asarray(_jax_selection(jnp.asarray(img))))
    np.testing.assert_array_equal(sel_t, np.broadcast_to(
        np.arange(8)[:, None, None], sel_t.shape))
    _filter_rule(tfilters.bm3d(torch.from_numpy(img), 25.0),
                 jfilters.bm3d(jnp.asarray(img), 25.0))


@pytest.mark.parametrize("kw", [
    dict(filter="gaussian", filter_size=5),
    dict(filter="nlm", nlm_search=7),
    dict(filter="bm3d", bm3d_sigma=15.0),
    dict(filter="gaussian", spatial="dwt", dwt_levels=2)])
def test_codec_filter_end_to_end(kw):
    img = _noisy(32, 48, seed=9, sigma=8.0)
    cfg = dict(qss=48, entropy="zlib", **kw)
    tc = Codec(CodecConfig(**cfg), device="cpu")
    jc = vcf_tpu.Codec(vcf_tpu.CodecConfig(**cfg))
    cs = tc.encode(img)
    blob = cs.to_bytes()
    rec_t = tc.decode(CodeStream.from_bytes(blob))
    rec_j = np.asarray(jc.decode(JCodeStream.from_bytes(blob)))
    assert rec_t.shape == img.shape and rec_t.dtype == np.uint8
    d = np.abs(rec_t.astype(np.int64) - rec_j)
    assert d.max() <= MAX_U8_DIFF
    assert np.count_nonzero(d > 1) <= MAX_U8_SHARE * d.size
    assert "device:filter" in tc.last_timings.as_dict()
    # the filter runs on the decoded frame
    unfiltered = Codec(CodecConfig(**{**cfg, "filter": "none"}),
                       device="cpu").decode(CodeStream.from_bytes(blob))
    np.testing.assert_array_equal(rec_t, tfilters.get(
        CodecConfig(**cfg), "cpu")(unfiltered))
