"""The port's KLT, MDCT and LBT (vcf_tpu_torch.ops.{klt,mdct,lbt}) and their
Codec flows against vcf_tpu's on the CPU, at 32x48 to 48x64.

Tolerances, each with its reason:
* KLT weights: atol 1e-5 after the sign rule, on blocks with a
  well-separated spectrum (an eigenvector moves by the covariance's
  rounding over the eigenvalue gap; near-equal eigenvalues make the
  eigenvectors arbitrary, ROADMAP C3); forward/inverse given vcf_tpu's
  weights atol 1e-4 (float32 sums of 16-64 products of magnitude <= 2^8
  in another order);
* MDCT: the matrix bit for bit (the same float64 numpy); analysis and
  synthesis atol 1e-4 (float32 sums in another order), and the round trip
  (TDAC) exact to 1e-4;
* LBT: 20 Adam epochs from the DCT basis within rtol 1e-4 of optax's
  (float32 gradients in another order; Adam divides them by their own
  size), one Adam step to 1 ulp (the same float32 operations, the bias
  corrections' powers in another library);
* the flows: each package decodes the other's stream under the pixel rule
  (|d| <= 1 on at most 0.1% of pixels: the inverse transforms' float32
  sums); MDCT's stored indexes under the +-1 rule (an index on a rounding
  edge may move by 1, on at most 0.01% of entries).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import vcf_tpu
from vcf_tpu.codestream import CodeStream as JCodeStream
from vcf_tpu.io import test_image as jax_test_image
from vcf_tpu.ops import klt as jklt
from vcf_tpu.ops import lbt as jlbt
from vcf_tpu.ops import mdct as jmdct
from vcf_tpu_torch import Codec, CodecConfig, CodeStream, metrics
from vcf_tpu_torch.ops import klt as tklt
from vcf_tpu_torch.ops import lbt as tlbt
from vcf_tpu_torch.ops import mdct as tmdct

MAX_PIXEL_DIFF, MAX_PIXEL_SHARE = 1, 1e-3
MAX_INDEX_DIFF, MAX_INDEX_SHARE = 1, 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pixel_rule(a, b):
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    assert a.shape == b.shape
    assert d.max() <= MAX_PIXEL_DIFF
    assert np.count_nonzero(d) <= MAX_PIXEL_SHARE * d.size


def _spectrum_blocks(c=3, n=96, d=16, seed=0):
    """(C, N, D) blocks whose covariance has well-separated eigenvalues."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(c):
        q, _ = np.linalg.qr(rng.normal(size=(d, d)))
        scale = 40.0 - 2.0 * np.arange(d)       # eigenvalue gaps >= 36
        z = rng.normal(size=(n, d))
        z = (z - z.mean(0)) / z.std(0)
        out.append(z @ np.diag(scale) @ q.T)
    return np.stack(out).astype(np.float32)


# ---------------------------------------------------------------------------
# KLT
# ---------------------------------------------------------------------------

def test_klt_train_weights_match_vcf_tpu():
    blocks = _spectrum_blocks()
    jw = np.asarray(jklt.train_weights(jnp.asarray(blocks)))
    tw = tklt.train_weights(_t(blocks)).numpy()
    np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-5)
    # orthonormal rows, the first largest-|.| entry of each positive
    np.testing.assert_allclose(tw @ tw.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(16), tw.shape),
                               atol=1e-5)
    idx = np.argmax(np.abs(tw), axis=2)
    assert (np.take_along_axis(tw, idx[..., None], 2) > 0).all()


def test_klt_blocks_and_transforms_match_vcf_tpu():
    img = np.random.default_rng(1).normal(0, 60, (32, 48, 3)).astype(
        np.float32)
    jb = np.asarray(jklt.channel_blocks(jnp.asarray(img), 8))
    tb = tklt.channel_blocks(_t(img), 8)
    np.testing.assert_array_equal(tb.numpy(), jb)
    np.testing.assert_array_equal(
        tklt.channel_unblocks(tb, 32, 48, 8).numpy(), img)
    w = np.asarray(jklt.train_weights(jnp.asarray(jb)))
    jc = np.asarray(jklt.forward(jnp.asarray(jb), jnp.asarray(w)))
    tc = tklt.forward(tb, _t(w)).numpy()
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-4)
    ji = np.asarray(jklt.inverse(jnp.asarray(jc), jnp.asarray(w)))
    np.testing.assert_allclose(tklt.inverse(_t(jc), _t(w)).numpy(), ji,
                               rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# MDCT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_mdct_matrix_bit_identical(n):
    np.testing.assert_array_equal(tmdct.mdct_matrix(n), jmdct.mdct_matrix(n))


@pytest.mark.parametrize("b", [4, 8])
def test_mdct_analysis_synthesis_match_vcf_tpu(b):
    x = np.random.default_rng(b).normal(0, 50, (32, 48, 3)).astype(np.float32)
    ja = np.asarray(jmdct.analyze(jnp.asarray(x), b))
    ta = tmdct.analyze(_t(x), b)
    assert ta.shape == (32 + b, 48 + b, 3)
    np.testing.assert_allclose(ta.numpy(), ja, rtol=0, atol=1e-4)
    js = np.asarray(jmdct.synthesize(jnp.asarray(ja), b, (32, 48)))
    ts = tmdct.synthesize(_t(ja), b, (32, 48)).numpy()
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-4)
    # TDAC: the overlap-add reconstructs the input
    np.testing.assert_allclose(tmdct.synthesize(ta, b, (32, 48)).numpy(), x,
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("quantizer", ["deadzone", "lloydmax"])
def test_mdct_coeff_scale_matches_vcf_tpu(quantizer):
    for b in (4, 8, 16, 32):
        assert tmdct.coeff_scale(b, quantizer) == jmdct.coeff_scale(b, quantizer)
        assert (tmdct.mdct_scale_factor(b, quantizer)
                == jmdct.mdct_scale_factor(b, quantizer))


# ---------------------------------------------------------------------------
# LBT
# ---------------------------------------------------------------------------

def _lbt_blocks():
    img = jax_test_image(32, 48, seed=4).astype(np.float32) - 128.0
    blocks = np.asarray(jlbt.blocks_of(jnp.asarray(img), 8))
    np.testing.assert_array_equal(tlbt.blocks_of(_t(img), 8).numpy(), blocks)
    return blocks - blocks.mean(0)


@pytest.mark.parametrize("coding_lambda", [0.0, 1e-2])
def test_lbt_train_matches_optax(coding_lambda):
    cen = _lbt_blocks()
    w0 = jlbt.dct_init(8)
    np.testing.assert_array_equal(tlbt.dct_init(8), w0)
    je, jd, _ = jlbt.train(jnp.asarray(cen), jnp.asarray(w0),
                           jnp.asarray(w0.T), epochs=20, lr=1e-3,
                           coding_lambda=coding_lambda)
    te, td = tlbt.train(_t(cen), _t(w0), _t(w0.T), epochs=20, lr=1e-3,
                        coding_lambda=coding_lambda)
    for t_w, j_w, init in ((te, je, w0), (td, jd, w0.T)):
        j_w = np.asarray(j_w)
        assert np.abs(j_w - init).max() > 1e-4      # training moved them
        np.testing.assert_allclose(t_w.numpy(), j_w, rtol=1e-4,
                                   atol=1e-4 * np.abs(j_w).max())


def test_adam_step_matches_optax_to_one_ulp():
    rng = np.random.default_rng(5)
    p = rng.normal(0, 0.2, (16, 16)).astype(np.float32)
    opt = optax.adam(1e-3)
    state = opt.init(jnp.asarray(p))
    jp = jnp.asarray(p)
    tp, mu, nu = _t(p), torch.zeros(16, 16), torch.zeros(16, 16)
    for t in range(1, 4):
        g = rng.normal(0, 1e-2, (16, 16)).astype(np.float32)
        upd, state = opt.update(jnp.asarray(g), state)
        jp = optax.apply_updates(jp, upd)
        tp, mu, nu = tlbt.adam_step(tp, _t(g), mu, nu, t, 1e-3)
        ulp = np.spacing(np.abs(np.asarray(jp)))
        assert (np.abs(tp.numpy() - np.asarray(jp)) <= ulp).all()
        np.testing.assert_allclose(mu.numpy(), np.asarray(state[0].mu),
                                   rtol=2e-7, atol=0)
        np.testing.assert_allclose(nu.numpy(), np.asarray(state[0].nu),
                                   rtol=2e-7, atol=0)


# ---------------------------------------------------------------------------
# The three flows through the Codec
# ---------------------------------------------------------------------------

FLOWS = {
    "klt": dict(spatial="klt", qss=16, entropy="zlib"),
    "klt-b4-lloydmax": dict(spatial="klt", block_size=4,
                            quantizer="lloydmax", entropy="zlib"),
    "mdct": dict(spatial="mdct", qss=16, entropy="zlib"),
    "mdct-lloydmax": dict(spatial="mdct", quantizer="lloydmax",
                          entropy="zlib"),
    "lbt": dict(spatial="lbt", qss=16, lbt_epochs=40, entropy="zlib"),
    "lbt-lambda": dict(spatial="lbt", lbt_epochs=40, lbt_lambda=1e-2,
                       entropy="zlib"),
}


@pytest.mark.parametrize("name", list(FLOWS))
def test_flow_streams_decode_in_both_packages(name):
    img = jax_test_image(40, 56, seed=6)
    jc = vcf_tpu.Codec(vcf_tpu.CodecConfig(**FLOWS[name]))
    tc = Codec(CodecConfig(**FLOWS[name]), device="cpu")
    cs_j, cs_t = jc.encode(img), tc.encode(img)
    blob_j, blob_t = cs_j.to_bytes(), cs_t.to_bytes()
    assert sorted(cs_t) == sorted(cs_j)
    rec_t = tc.decode(CodeStream.from_bytes(blob_t))
    assert rec_t.shape == img.shape and rec_t.dtype == np.uint8
    # each stream decodes in the other package as in its own
    _pixel_rule(tc.decode(CodeStream.from_bytes(blob_j)),
                jc.decode(JCodeStream.from_bytes(blob_j)))
    _pixel_rule(np.asarray(jc.decode(JCodeStream.from_bytes(blob_t))), rec_t)
    assert abs(metrics.rmse(img, rec_t)
               - metrics.rmse(img, jc.decode(cs_j))) < 0.5


@pytest.mark.parametrize("quantizer", ["deadzone", "lloydmax"])
def test_mdct_stored_indexes_match_vcf_tpu(quantizer):
    img = jax_test_image(48, 64, seed=7)
    kw = dict(spatial="mdct", quantizer=quantizer, entropy="zlib")
    tc = Codec(CodecConfig(**kw), device="cpu")
    jc = vcf_tpu.Codec(vcf_tpu.CodecConfig(**kw))
    cs_t, cs_j = tc.encode(img), jc.encode(img)
    k_t = tc._load_indexes(cs_t, offset=tc.spatial_offset, signed=True)[0]
    k_j = jc._load_indexes(cs_j, offset=jc.spatial_offset, signed=True)[0]
    assert k_t.shape == (56, 72, 3) == k_j.shape
    d = np.abs(k_t - k_j)
    assert d.max() <= MAX_INDEX_DIFF
    assert np.count_nonzero(d) <= MAX_INDEX_SHARE * d.size
    if not d.any():
        assert cs_t.to_bytes() == cs_j.to_bytes()


def test_lbt_side_info_external_file(tmp_path):
    """lbt_side_info stores the trained weights in an .npz file outside
    the stream (2D-LBT.py:39,48,391-398), which each package reads."""
    img = jax_test_image(32, 48, seed=8)
    path = str(tmp_path / "w.npz")
    kw = dict(spatial="lbt", qss=16, lbt_epochs=40, entropy="zlib",
              lbt_side_info=path)
    tc = Codec(CodecConfig(**kw), device="cpu")
    cs = tc.encode(img)
    assert "weights" not in cs and "mean" not in cs
    assert os.path.exists(path)
    rec = tc.decode(CodeStream.from_bytes(cs.to_bytes()))
    assert metrics.rmse(img, rec) < 10.0
    jc = vcf_tpu.Codec(vcf_tpu.CodecConfig(**kw))
    _pixel_rule(np.asarray(jc.decode(JCodeStream.from_bytes(cs.to_bytes()))),
                rec)
    # a path without the suffix names the file np.savez wrote
    bare = str(tmp_path / "bare")
    kw["lbt_side_info"] = bare
    cs = Codec(CodecConfig(**kw), device="cpu").encode(img)
    assert os.path.exists(bare + ".npz")
    _pixel_rule(Codec(CodecConfig(**kw), device="cpu").decode(cs), rec)
