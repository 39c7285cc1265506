"""The plain torch versions of kernels B1-B4 (vcf_tpu_torch.ops.cuda.
dct_kernel) against vcf_tpu's Pallas kernels run with interpret=True,
on the same numpy-seeded inputs, and the wrappers' routing.

Tolerances, each with its reason:
* quantization indexes (B1, B3): the +-1 rule — a float32 sum taken in
  another order may move an index across a rounding edge by 1, on at
  most 0.01% of entries (MAX_DIFF_SHARE);
* float planes (B2): within 1e-3 absolute (sums of 8 products of
  magnitude <= 2^13 in another order, ~2^13 * 2^-24 per rounding);
* decoded pixels (B4): d.max() <= 1 and (d != 0).mean() < 1e-3, the
  rule of tests/test_parallel.py for vcf_tpu's own fused decode.
qss=24 pins the kernels' reciprocal rule (trunc(c * float32(1/24)));
96x112 is a shape that is not a multiple of the TPU's 32x128 tile.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vcf_tpu.ops import color as jcolor
from vcf_tpu.ops import dct as jdct
from vcf_tpu.ops.pallas import dct_kernel as jk
from vcf_tpu_torch.ops import dct as tdct
from vcf_tpu_torch.ops.cuda import dct_kernel as tk

MAX_DIFF_SHARE = 1e-4
MATS = {"ycocg": (jcolor.YCOCG_FWD, jcolor.YCOCG_INV),
        "ycrcb": (jcolor.YCRCB_FWD, jcolor.YCRCB_INV),
        "cdct": (jcolor.CDCT_FWD, jcolor.CDCT_INV)}

# (h, w, b, qss): both block sizes and both quantizer steps, on the
# 32x128-tiled shape and the untiled 96x112
CASES = [(64, 128, 8, 32), (64, 128, 4, 24), (96, 112, 8, 24),
         (96, 112, 4, 32)]


def _pixels(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


def _planes(shape, seed):
    return np.random.default_rng(seed).normal(0, 80, shape).astype(np.float32)


def _index_rule(got, want):
    d = np.abs(np.asarray(got).astype(np.int64) - np.asarray(want))
    assert d.max() <= 1
    assert np.count_nonzero(d) <= MAX_DIFF_SHARE * d.size


def _pixel_rule(got, want):
    d = np.abs(np.asarray(got).astype(np.int64) - np.asarray(want))
    assert d.max() <= 1 and (d != 0).mean() < 1e-3


@pytest.mark.parametrize("perceptual", [False, True])
@pytest.mark.parametrize("h,w,b,qss", CASES)
def test_b1_b2_match_pallas(h, w, b, qss, perceptual):
    planes = _planes((3, h, w), seed=h + b + qss)
    kw = dict(b=b, qss=qss, perceptual=perceptual)
    k_j = np.array(jk.fused_dct_quantize(jnp.asarray(planes),
                                         interpret=True, **kw))
    k_t = tk.fused_dct_quantize(torch.from_numpy(planes), **kw).numpy()
    _index_rule(k_t, k_j)
    x_j = np.asarray(jk.fused_dequantize_idct(jnp.asarray(k_j),
                                              interpret=True, **kw))
    x_t = tk.fused_dequantize_idct(torch.from_numpy(k_j), **kw).numpy()
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=1e-3)


@pytest.mark.parametrize("color", ["ycocg", "ycrcb", "cdct"])
@pytest.mark.parametrize("h,w,b,qss", CASES)
def test_b3_b4_match_pallas(h, w, b, qss, color):
    px = _pixels((3, h, w), seed=w + b + qss)
    fwd, inv = MATS[color]
    k_j = np.array(jk.fused_cdct_quantize(
        jnp.asarray(px), jk.static_mat(fwd), b=b, qss=qss, interpret=True))
    k_t = tk.fused_cdct_quantize(torch.from_numpy(px), tk.static_mat(fwd),
                                 b=b, qss=qss).numpy()
    _index_rule(k_t, k_j)
    p_j = np.asarray(jk.fused_dequantize_cdct(
        jnp.asarray(k_j), jk.static_mat(inv), b=b, qss=qss, interpret=True))
    p_t = tk.fused_dequantize_cdct(torch.from_numpy(k_j), tk.static_mat(inv),
                                   b=b, qss=qss).numpy()
    _pixel_rule(p_t, p_j)


# the other block sizes of B2/B4 (CASES has b = 4 and 8): the inverse
# kernel has an instance for each b
INV_BLOCK_SIZES = [2, 16, 32]
INV_KINDS = ["B2", "B2-perceptual", "B4"]


def _inverse_pair(kind: str, b: int, grid_layout: bool):
    """(vcf_tpu's interpret-mode output, the port's) of B2 or B4 at
    3x64x256, qss 32, on the indexes the port's B1/B3 give for seeded
    planes or pixels."""
    kw = dict(b=b, qss=32, grid_layout=grid_layout)
    if kind == "B4":
        px = torch.from_numpy(_pixels((3, 64, 256), seed=b))
        k = tk.fused_cdct_quantize(px, tk.static_mat(jcolor.YCOCG_FWD), **kw)
        inv = jk.static_mat(jcolor.YCOCG_INV)
        want = jk.fused_dequantize_cdct(jnp.asarray(k.numpy()), inv,
                                        interpret=True, **kw)
        return np.asarray(want), tk.fused_dequantize_cdct(k, inv, **kw)
    kw["perceptual"] = kind == "B2-perceptual"
    k = tk.fused_dct_quantize(torch.from_numpy(_planes((3, 64, 256), seed=b)),
                              **kw)
    want = jk.fused_dequantize_idct(jnp.asarray(k.numpy()), interpret=True,
                                    **kw)
    return np.asarray(want), tk.fused_dequantize_idct(k, **kw)


@pytest.mark.parametrize("kind", INV_KINDS)
@pytest.mark.parametrize("b", INV_BLOCK_SIZES)
def test_b2_b4_block_sizes_match_pallas(b, kind):
    want, got = _inverse_pair(kind, b, grid_layout=False)
    if kind == "B4":
        _pixel_rule(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


# every block size of the forward kernel (an instance each) in both
# layouts; vcf_tpu takes each b at 64x256 (H % 32 == 0, 32 % b == 0)
FWD_BLOCK_SIZES = [1, 2, 4, 8, 16, 32]
FWD_KINDS = ["B1", "B1-perceptual", "B3"]


@pytest.mark.parametrize("grid_layout", [False, True], ids=["block", "grid"])
@pytest.mark.parametrize("kind", FWD_KINDS)
@pytest.mark.parametrize("b", FWD_BLOCK_SIZES)
def test_b1_b3_block_sizes_match_pallas(b, kind, grid_layout):
    kw = dict(b=b, qss=24, grid_layout=grid_layout)
    if kind == "B3":
        px = _pixels((3, 64, 256), seed=b)
        m = jk.static_mat(jcolor.YCOCG_FWD)
        want = jk.fused_cdct_quantize(jnp.asarray(px), m, interpret=True, **kw)
        got = tk.fused_cdct_quantize(torch.from_numpy(px),
                                     tk.static_mat(jcolor.YCOCG_FWD), **kw)
    else:
        planes = _planes((3, 64, 256), seed=b)
        kw["perceptual"] = kind == "B1-perceptual"
        want = jk.fused_dct_quantize(jnp.asarray(planes), interpret=True, **kw)
        got = tk.fused_dct_quantize(torch.from_numpy(planes), **kw)
    _index_rule(got.numpy(), np.asarray(want))


def test_frame_axis_is_per_frame():
    """(N, C, H, W) gives each frame's (C, H, W) result: the frame axis
    stands for vcf_tpu's jax.vmap."""
    px = torch.from_numpy(_pixels((3, 3, 32, 48), seed=1))
    planes = torch.from_numpy(_planes((3, 2, 32, 48), seed=2))
    m = tk.static_mat(jcolor.YCOCG_FWD)
    k = tk.fused_cdct_quantize(px, m)
    assert torch.equal(k, torch.stack([tk.fused_cdct_quantize(f, m)
                                       for f in px]))
    k1 = tk.fused_dct_quantize(planes, perceptual=True)
    assert torch.equal(k1, torch.stack([tk.fused_dct_quantize(
        f, perceptual=True) for f in planes]))
    x = tk.fused_dequantize_idct(k1, perceptual=True)
    assert torch.equal(x, torch.stack([tk.fused_dequantize_idct(
        f, perceptual=True) for f in k1]))


def test_indexes_saturate():
    """Out-of-range indexes clip to [0, 255] (src/deadzone.py:64), as in
    vcf_tpu's kernels, at qss=1 where the DC coefficients overflow."""
    px = np.zeros((3, 32, 128), np.uint8)
    px[:, :, 64:] = 255
    m = jk.static_mat(jcolor.YCOCG_FWD)
    k_t = tk.fused_cdct_quantize(torch.from_numpy(px), tk.static_mat(
        jcolor.YCOCG_FWD), qss=1).numpy()
    k_j = np.array(jk.fused_cdct_quantize(jnp.asarray(px), m, qss=1,
                                          interpret=True))
    np.testing.assert_array_equal(k_t, k_j)
    assert k_t.min() == 0 and k_t.max() == 255


def test_wrappers_route_by_device():
    planes = torch.from_numpy(_planes((3, 16, 16), seed=3))
    before = tk.fused_dct_quantize.launches
    tk.fused_dct_quantize(planes)                  # CPU: the plain version
    assert tk.fused_dct_quantize.launches == before
    with pytest.raises(ValueError, match="no kernel for device"):
        tk.fused_dct_quantize(planes.to("meta"))
    with pytest.raises(ValueError, match="does not divide 32"):
        tk.fused_dct_quantize(planes, b=3)
    with pytest.raises(ValueError, match="multiple of b=8"):
        tk.fused_dct_quantize(planes[:, :12])
    with pytest.raises(ValueError, match="float32"):
        tk.fused_dct_quantize(planes.to(torch.float64))
    with pytest.raises(ValueError, match="3 channels"):
        tk.fused_cdct_quantize(torch.zeros((2, 16, 16), dtype=torch.uint8),
                               tk.static_mat(jcolor.YCOCG_FWD))
    # the `_any` names call the same functions, and refuse grid_layout
    # where vcf_tpu's would pad (H % 32 or W % 128)
    k = tk.fused_dct_quantize_any(planes)
    assert torch.equal(k, tk.fused_dct_quantize(planes))
    assert torch.equal(tk.fused_dequantize_idct_any(k),
                       tk.fused_dequantize_idct(k))
    with pytest.raises(ValueError, match="kernel-native"):
        tk.fused_dct_quantize_any(planes, grid_layout=True)
    with pytest.raises(ValueError, match="kernel-native"):
        tk.fused_dequantize_idct_any(k, grid_layout=True)


def test_static_mat_equals_vcf_tpu():
    for fwd, inv in MATS.values():
        assert tk.static_mat(fwd) == jk.static_mat(fwd)
        assert tk.static_mat(inv) == jk.static_mat(inv)


@pytest.mark.parametrize("b", [1, 2, 4, 8, 16, 32])
def test_perceptual_tables_equal_vcf_tpu(b):
    for got, want in zip(tdct.perceptual_tables(b),
                         jdct.perceptual_tables(b)):
        np.testing.assert_array_equal(got, want)


def test_perceptual_scale_matches_vcf_tpu():
    x = _planes((2, 16, 24, 3), seed=4)
    for inverse in (False, True):
        want = np.stack([np.asarray(jdct.perceptual_scale(
            jnp.asarray(f), 8, inverse=inverse)) for f in x])
        got = tdct.perceptual_scale(torch.from_numpy(x), 8, inverse=inverse)
        np.testing.assert_array_equal(got.numpy(), want)
