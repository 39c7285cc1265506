"""The port's device-resident lane-grid path against vcf_tpu's, on the CPU:
the subband-grid layout of B1-B4, the four lane functions, K1's L-major
input, the row-compacting encode and `assemble_stream`, the routing-free
grid decodes (order 0 and context), and IPPCodec's planar grid loop.

vcf_tpu's Pallas functions run with interpret=True, as its own tests run
them; the port's wrappers run their plain torch versions.  Tolerances,
each with its reason:
* lanes, raw grids, states, row prefixes, words, decoded symbols: equal
  (reshapes and exact integer coding);
* quantization indexes (B1, B3) against vcf_tpu: the +-1 rule (float32
  sums in another order move an index across a rounding edge by 1, on at
  most 0.01% of entries); B2 floats within 1e-3, B4 pixels +-1 on under
  0.1%, as tests/test_torch_dct_kernels.py;
* the port's grid output against its own block output permuted: equal
  (the grid mode permutes, it does not recompute);
* the planar IPP loop: mvs equal, indexes +-1 on at most 0.05%
  (ROADMAP C7), reconstruction rmse within 1e-2 of vcf_tpu's, decoder
  equal to encoder bit for bit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import vcf_tpu
import vcf_tpu.video as jvideo
from vcf_tpu.entropy import rans as jrans
from vcf_tpu.io.video import test_video as make_test_video
from vcf_tpu.ops import color as jcolor
from vcf_tpu.ops.pallas import dct_kernel as jk
from vcf_tpu.ops.pallas import rans_ctx as jrc
from vcf_tpu.ops.pallas import rans_decode as jrd
from vcf_tpu.ops.pallas import rans_encode as jre
from vcf_tpu_torch import CodecConfig, video
from vcf_tpu_torch.config import VideoConfig
from vcf_tpu_torch.entropy import rans as trans
from vcf_tpu_torch.ops.cuda import dct_kernel as tk
from vcf_tpu_torch.ops.cuda import rans_ctx as trc
from vcf_tpu_torch.ops.cuda import rans_decode as trd
from vcf_tpu_torch.ops.cuda import rans_encode as tre

MAX_DIFF_SHARE = 1e-4
MAX_IPP_DIFF_SHARE = 5e-4
# the (G, SG, L) of tests/test_pallas_r5.py
G, SG, L = 4, 8, 12
LANE_FUNCS = ["grid_lanes", "grid_lanes_lmajor", "grid_unlanes",
              "grid_unlanes_lmajor"]
# (h, w, b, qss): cw = 256 (w 256), 128 (b 4), 512 (w 2048), 96 (w 96)
DCT_CASES = [(64, 256, 8, 32), (64, 128, 4, 24), (32, 2048, 8, 32),
             (32, 96, 8, 24)]


def _index_rule(got, want, share=MAX_DIFF_SHARE):
    d = np.abs(np.asarray(got).astype(np.int64) - np.asarray(want))
    assert d.max() <= 1
    assert np.count_nonzero(d) <= share * d.size


def _grid_planes(seed, shape=(2, 3, 64, 256)):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [96, 128, 256, 352, 1920, 2048])
def test_chunk_w_equals_vcf_tpu(w):
    for b in (4, 8):
        assert tk._chunk_w(w, b) == jk._chunk_w(w, b)


@pytest.mark.parametrize("b,w", [(8, 128), (8, 256), (8, 2048), (4, 128)])
def test_to_grid_is_vcf_tpu_grid_perm(b, w):
    """New tile index g * (n / b) + blk holds old blk * b + g, along the
    32 tile rows and the cw tile columns (vcf_tpu `_grid_perm`)."""
    x = _grid_planes(b + w, (2, 3, 64, w))
    cw = jk._chunk_w(w, b)
    pr, pc = jk._grid_perm(32, b), jk._grid_perm(cw, b)
    want = x.reshape(2, 3, 2, 32, w // cw, cw)[:, :, :, pr][..., pc]
    got = tk.to_grid(torch.from_numpy(x), b)
    np.testing.assert_array_equal(got.numpy(), want.reshape(x.shape))
    assert torch.equal(tk.from_grid(got, b), torch.from_numpy(x))


@pytest.mark.parametrize("name", LANE_FUNCS)
def test_lane_functions_equal_vcf_tpu(name):
    """2x3x64x256 grid planes, 512 lanes (sg 8, L 192), cw 256."""
    planes = _grid_planes(5)
    b, s, cw = 8, 512, jk._chunk_w(256, 8)
    kw = dict(rows=32, cw=cw)
    if name.startswith("grid_lanes"):
        args_j, args_t = (jnp.asarray(planes), b, s), (torch.from_numpy(planes),
                                                       b, s)
    else:
        lanes = np.asarray(jrans.grid_lanes(jnp.asarray(planes), b, s, **kw))
        lanes = np.array(lanes.T if name.endswith("lmajor") else lanes)
        args_j = (jnp.asarray(lanes), b, planes.shape)
        args_t = (torch.from_numpy(lanes), b, planes.shape)
    want = np.asarray(getattr(jrans, name)(*args_j, **kw))
    got = getattr(trans, name)(*args_t, **kw)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    if not name.startswith("grid_lanes"):
        np.testing.assert_array_equal(got.numpy(), planes)


def test_lane_functions_raise_on_shapes_that_do_not_tile():
    planes = torch.zeros((1, 3, 48, 256), dtype=torch.uint8)
    with pytest.raises(ValueError, match="do not tile"):
        trans.grid_lanes_lmajor(planes, 8, 512, cw=256)
    with pytest.raises(ValueError, match="do not tile"):
        trans.grid_lanes(torch.zeros((1, 3, 32, 256), dtype=torch.uint8), 8,
                         64 * 7, cw=256)


# ---------------------------------------------------------------------------
# B1-B4 grid modes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("perceptual", [False, True])
@pytest.mark.parametrize("h,w,b,qss", DCT_CASES)
def test_b1_b2_grid_match_pallas(h, w, b, qss, perceptual):
    planes = np.random.default_rng(h + w + b).normal(
        0, 80, (3, h, w)).astype(np.float32)
    kw = dict(b=b, qss=qss, perceptual=perceptual, grid_layout=True)
    k_j = np.array(jk.fused_dct_quantize(jnp.asarray(planes), interpret=True,
                                         **kw))
    k_t = tk.fused_dct_quantize(torch.from_numpy(planes), **kw)
    _index_rule(k_t.numpy(), k_j)
    block = tk.fused_dct_quantize(torch.from_numpy(planes), b=b, qss=qss,
                                  perceptual=perceptual)
    assert torch.equal(k_t, tk.to_grid(block, b))
    x_j = np.asarray(jk.fused_dequantize_idct(jnp.asarray(k_j),
                                              interpret=True, **kw))
    x_t = tk.fused_dequantize_idct(torch.from_numpy(k_j), **kw)
    np.testing.assert_allclose(x_t.numpy(), x_j, rtol=0, atol=1e-3)
    assert torch.equal(x_t, tk.fused_dequantize_idct(
        tk.from_grid(torch.from_numpy(k_j), b), b=b, qss=qss,
        perceptual=perceptual))


@pytest.mark.parametrize("h,w,b,qss", DCT_CASES)
def test_b3_b4_grid_match_pallas(h, w, b, qss):
    px = np.random.default_rng(h * w + qss).integers(
        0, 256, (3, h, w)).astype(np.uint8)
    mf, mi = jk.static_mat(jcolor.YCOCG_FWD), jk.static_mat(jcolor.YCOCG_INV)
    kw = dict(b=b, qss=qss, grid_layout=True)
    k_j = np.array(jk.fused_cdct_quantize(jnp.asarray(px), mf,
                                          interpret=True, **kw))
    k_t = tk.fused_cdct_quantize(torch.from_numpy(px), mf, **kw)
    _index_rule(k_t.numpy(), k_j)
    assert torch.equal(k_t, tk.to_grid(tk.fused_cdct_quantize(
        torch.from_numpy(px), mf, b=b, qss=qss), b))
    p_j = np.asarray(jk.fused_dequantize_cdct(jnp.asarray(k_j), mi,
                                              interpret=True, **kw))
    p_t = tk.fused_dequantize_cdct(torch.from_numpy(k_j), mi, **kw)
    d = np.abs(p_t.numpy().astype(np.int64) - p_j)
    assert d.max() <= 1 and (d != 0).mean() < 1e-3
    assert torch.equal(p_t, tk.fused_dequantize_cdct(
        tk.from_grid(torch.from_numpy(k_j), b), mi, b=b, qss=qss))


@pytest.mark.parametrize("kind", ["B2", "B2-perceptual", "B4"])
@pytest.mark.parametrize("b", [2, 16, 32])
def test_b2_b4_grid_block_sizes_match_pallas(b, kind):
    """B2/B4's grid mode at the block sizes DCT_CASES lacks (the inverse
    kernel has an instance for each b), 3x64x256, qss 32, against
    vcf_tpu's interpret-mode kernels and the port's block mode."""
    rng = np.random.default_rng(b)
    kw = dict(b=b, qss=32, grid_layout=True)
    if kind == "B4":
        px = torch.from_numpy(rng.integers(0, 256, (3, 64, 256), np.uint8))
        k = tk.fused_cdct_quantize(px, tk.static_mat(jcolor.YCOCG_FWD), **kw)
        mi = jk.static_mat(jcolor.YCOCG_INV)
        want = np.asarray(jk.fused_dequantize_cdct(
            jnp.asarray(k.numpy()), mi, interpret=True, **kw))
        got = tk.fused_dequantize_cdct(k, mi, **kw)
        d = np.abs(got.numpy().astype(np.int64) - want)
        assert d.max() <= 1 and (d != 0).mean() < 1e-3
        block = tk.fused_dequantize_cdct(tk.from_grid(k, b), mi, b=b, qss=32)
    else:
        kw["perceptual"] = kind == "B2-perceptual"
        planes = rng.normal(0, 80, (3, 64, 256)).astype(np.float32)
        k = tk.fused_dct_quantize(torch.from_numpy(planes), **kw)
        want = np.asarray(jk.fused_dequantize_idct(
            jnp.asarray(k.numpy()), interpret=True, **kw))
        got = tk.fused_dequantize_idct(k, **kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
        block = tk.fused_dequantize_idct(tk.from_grid(k, b), b=b, qss=32,
                                         perceptual=kw["perceptual"])
    assert torch.equal(got, block)


def test_grid_layout_shape_checks():
    px = torch.zeros((3, 48, 128), dtype=torch.uint8)
    m = tk.static_mat(jcolor.YCOCG_FWD)
    with pytest.raises(ValueError, match="H % 32"):
        tk.fused_cdct_quantize(px, m, grid_layout=True)
    with pytest.raises(ValueError, match="H % 32"):
        tk.fused_dequantize_cdct(px, m, grid_layout=True)
    k = tk.fused_cdct_quantize(px[:, :32], m, grid_layout=True)   # tiles
    assert k.shape == (3, 32, 128)


# ---------------------------------------------------------------------------
# The rANS modes
# ---------------------------------------------------------------------------

def _grouped_case(g, sg, l, seed):
    """A (G, SG, L) grouped case with vcf_tpu's raw grid and states."""
    rng = np.random.default_rng(seed)
    syms = rng.integers(0, 256, (g * sg, l), np.uint8)
    counts = rng.integers(1, 1000, (256,))
    fr = np.stack([jrans.quantize_freqs(np.roll(counts, i), min_all=True)
                   for i in range(g)]).astype(np.uint32)
    cu = np.concatenate([np.zeros((g, 1), np.uint32),
                         np.cumsum(fr, 1)[:, :255]], 1).astype(np.uint32)
    le, st = jre.pallas_encode_grouped_raw(
        jnp.asarray(syms), jnp.asarray(fr), jnp.asarray(cu), unroll=4, sg=sg,
        interpret=True)
    return dict(syms=syms, fr=fr, cu=cu, sg=sg, le=np.asarray(le),
                st=np.asarray(st).astype(np.int64),
                ft=torch.from_numpy(fr.astype(np.int64)),
                ct=torch.from_numpy(cu.astype(np.int64)))


@pytest.fixture(scope="module")
def grouped():
    """tests/test_pallas_r5.py's (G, SG, L) grouped case, with vcf_tpu's
    raw grid and states."""
    return _grouped_case(G, SG, L, 11)


@pytest.fixture(scope="module")
def grouped_ragged():
    """A grouped case whose S = 15 lanes are not a multiple of 4 (the row
    mode's kernel then takes 4-byte loads)."""
    return _grouped_case(3, 5, L, 13)


def test_k1_lmajor_matches_raw_u8(grouped):
    syms_l = np.ascontiguousarray(grouped["syms"].T)
    le_j, st_j = jre.pallas_encode_grouped_raw_u8(
        jnp.asarray(syms_l), jnp.asarray(grouped["fr"]),
        jnp.asarray(grouped["cu"]), unroll=4, sg=SG, interpret=True,
        lmajor=True)
    # the (L, S) lanes reach K1 as their transposed view, with no copy
    raw, st = tre.rans_encode_grouped(torch.from_numpy(syms_l).t(),
                                      grouped["ft"], grouped["ct"])
    np.testing.assert_array_equal(raw.numpy(), np.asarray(le_j))
    np.testing.assert_array_equal(st.numpy(), np.asarray(st_j).astype(np.int64))
    np.testing.assert_array_equal(raw.numpy(), grouped["le"])


@pytest.fixture(scope="module")
def pallas_rows(grouped, grouped_ragged):
    """vcf_tpu's compacting encodes by layout (a "-ragged" suffix: on the
    S = 15 case): (rows, counts, states) as numpy, each computed once."""
    cache = {}

    def get(layout):
        if layout not in cache:
            case = grouped_ragged if layout.endswith("-ragged") else grouped
            kind = layout.removesuffix("-ragged")
            syms, sg = case["syms"], case["sg"]
            fj, cj = jnp.asarray(case["fr"]), jnp.asarray(case["cu"])
            if kind == "grouped":
                out = jre.pallas_encode_grouped(jnp.asarray(syms), fj, cj,
                                                unroll=1, sg=sg, interpret=True)
            else:
                lmajor = kind == "u8-lmajor"
                out = jre.pallas_encode_grouped_u8(
                    jnp.asarray(syms.T if lmajor else syms), fj, cj, unroll=1,
                    sg=sg, interpret=True, lmajor=lmajor)
            cache[layout] = tuple(np.asarray(x) for x in out)
        return cache[layout]

    return get


@pytest.mark.parametrize("layout", ["grouped", "u8", "u8-lmajor",
                                    "grouped-ragged", "u8-ragged"])
def test_encode_rows_matches_pallas(grouped, grouped_ragged, pallas_rows,
                                    layout):
    """Counts, states and each row's prefix equal vcf_tpu's compacting
    encodes (their row tails are unspecified; the plain version's are
    zero).  The (L, S) layout reaches the port as a transposed view; the
    ragged case has S = 15 lanes."""
    case = grouped_ragged if layout.endswith("-ragged") else grouped
    syms = torch.from_numpy(case["syms"])
    if layout == "u8-lmajor":
        syms = syms.t().contiguous().t()
    rows_j, cnt_j, st_j = pallas_rows(layout)
    rows, counts, st = tre.rans_encode_rows(syms, case["ft"], case["ct"])
    assert rows.dtype == torch.int16 and rows.shape == rows_j.shape
    np.testing.assert_array_equal(counts.numpy(), cnt_j)
    np.testing.assert_array_equal(st.numpy(), st_j.astype(np.int64))
    for t, c in enumerate(cnt_j):
        np.testing.assert_array_equal(rows[t, :c].numpy(), rows_j[t, :c])
        assert not rows[t, c:].any()


def test_assemble_stream_matches_pallas_and_k2(grouped, pallas_rows):
    rows_j, cnt_j, _ = pallas_rows("grouped")
    w_j, n_j = jre.assemble_stream(jnp.asarray(rows_j), jnp.asarray(cnt_j))
    rows, counts, _ = tre.rans_encode_rows(
        torch.from_numpy(grouped["syms"]), grouped["ft"], grouped["ct"])
    words, n_words = tre.assemble_stream(rows, counts)
    n = int(n_words)
    assert n == int(n_j) and words.dtype == torch.uint16
    assert words.shape == (L * G * SG,)
    np.testing.assert_array_equal(words[:n].numpy(), np.asarray(w_j)[:n])
    w2, n2, c2 = tre.rans_compact(torch.from_numpy(grouped["le"]))
    assert int(n2) == n and torch.equal(words[:n], w2[:n])
    assert torch.equal(c2, counts)
    # a column slice rows[:, :cap] (bench.py's CAPW) gives the same words
    cap = int(counts.max())
    w3, n3 = tre.assemble_stream(rows[:, :cap], counts)
    assert int(n3) == n and w3.shape == (L * cap,)
    assert torch.equal(w3[:n], words[:n])
    with pytest.raises(ValueError, match="more than"):
        tre.assemble_stream(rows[:, :cap - 1], counts)


@pytest.mark.parametrize("lmajor", [False, True])
def test_grid_decode_matches_pallas(grouped, lmajor):
    want = np.asarray(jrd.pallas_decode_grouped_grid(
        jnp.asarray(grouped["le"]), jnp.asarray(grouped["st"].astype(np.uint32)),
        jnp.asarray(grouped["fr"]), jnp.asarray(grouped["cu"]), L, unroll=4,
        sg=SG, interpret=True, lmajor=lmajor))
    got = trd.rans_decode_grouped_grid(
        torch.from_numpy(grouped["le"]), torch.from_numpy(grouped["st"]),
        grouped["ft"], grouped["ct"], L)
    if lmajor:          # the port's output is a view; .t() is (L, S)
        got = got.t()
        assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    syms = grouped["syms"]
    np.testing.assert_array_equal(got.numpy(), syms.T if lmajor else syms)


def test_grid_decode_raises_on_a_bad_grid(grouped):
    raw = torch.from_numpy(grouped["le"].copy())
    st = torch.from_numpy(grouped["st"])
    t, s = np.argwhere(grouped["le"] >> 16)[0]
    raw[t, s] &= 0xFFFF                         # drop one emit flag
    with pytest.raises(ValueError, match="emit flags"):
        trd.rans_decode_grouped_grid(raw, st, grouped["ft"], grouped["ct"], L)
    with pytest.raises(ValueError, match="int32"):
        trd.rans_decode_grouped_grid(raw.to(torch.int64), st, grouped["ft"],
                                     grouped["ct"], L)
    with pytest.raises(ValueError, match="is not"):
        trd.rans_decode_grouped_grid(raw[:-1], st, grouped["ft"],
                                     grouped["ct"], L)


@pytest.mark.parametrize("n_ctx", [4, 15])
def test_ctx_grid_decode_matches_pallas(n_ctx):
    rng = np.random.default_rng(12 + n_ctx)
    syms = (128 + rng.normal(0, 30, (G * SG, 16))).clip(0, 255).astype(
        np.uint8)
    fgc, cgc = jrans.ctx_freqs_from_counts(
        np.asarray(jrans.ctx_group_histograms(jnp.asarray(syms), G, n_ctx)))
    fj, cj = jnp.asarray(fgc), jnp.asarray(cgc)
    le, st = jrc.pallas_encode_ctx_raw_u8(jnp.asarray(syms), fj, cj, unroll=1,
                                          sg=SG, interpret=True)
    want = np.asarray(jrc.pallas_decode_ctx_grid(le, st, fj, cj, 16, unroll=1,
                                                 sg=SG, interpret=True))
    ft = torch.from_numpy(np.asarray(fgc).astype(np.int64))
    ct = torch.from_numpy(np.asarray(cgc).astype(np.int64))
    raw_t, st_t = trc.rans_encode_ctx(torch.from_numpy(syms), ft, ct)
    np.testing.assert_array_equal(raw_t.numpy(), np.asarray(le))
    got = trc.rans_decode_ctx_grid(raw_t, st_t, ft, ct, 16)
    assert got.shape == syms.shape and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), syms)


def test_ctx_grid_decode_ref_raises_on_a_bad_grid():
    """The context mode's plain version raises as the kernel does: a
    dropped emit flag, a state that does not end at RANS_L."""
    rng = np.random.default_rng(21)
    syms = torch.from_numpy((128 + rng.normal(0, 30, (G * SG, 16))).clip(
        0, 255).astype(np.uint8))
    fgc, cgc = trans.ctx_freqs_from_counts(
        trans.ctx_group_histograms(syms, G, 4).numpy())
    ft = torch.from_numpy(fgc.astype(np.int64))
    ct = torch.from_numpy(cgc.astype(np.int64))
    raw, st = trc.rans_encode_ctx(syms, ft, ct)
    assert torch.equal(trc.rans_decode_ctx_grid(raw, st, ft, ct, 16), syms)
    bad = raw.clone()
    t, s = (bad >> 16).nonzero()[0].tolist()
    bad[t, s] &= 0xFFFF
    with pytest.raises(ValueError, match="emit flags"):
        trc.rans_decode_ctx_grid(bad, st, ft, ct, 16)
    st_bad = st ^ 1      # every lane's state off by one bit
    with pytest.raises(ValueError, match="emit flags"):
        trc.rans_decode_ctx_grid_ref(raw, st_bad, ft, ct, 16)
    with pytest.raises(ValueError, match="is not"):
        trc.rans_decode_ctx_grid(raw[:-1], st, ft, ct, 16)


# decode_plan_for at the main path's shapes on a 132-SM card: 3e's
# grids (S = 65536, G = 64; order 0, 4 and 15 classes), the DWT grid
# (17 x 512 lanes: 64-lane blocks), 8192 lanes (32), sg = 2 (global
# tables), 15 classes over two groups a 128-lane block.  Shared memory:
# the two tile stages (32 steps x lanes x 4 bytes each), then per table
# row 1024 (order 0) or 514 (context) bytes and a bucket row of
# 2^(15 - shift) + 4 bytes, at the least shift whose tables fit 24 KiB
PLAN_CASES = [
    ((65536, 64, 0), (128, "shared", 3, 32768 + 1024 + 4100)),
    ((65536, 64, 4), (128, "shared", 3, 32768 + 4 * (514 + 4100))),
    ((65536, 64, 15), (128, "shared", 5, 32768 + 15 * (514 + 1028))),
    ((8704, 17, 4), (64, "shared", 3, 16384 + 4 * (514 + 4100))),
    ((8704, 17, 0), (64, "shared", 3, 16384 + 1024 + 4100)),
    ((8192, 64, 0), (32, "shared", 3, 8192 + 1024 + 4100)),
    ((16896, 8448, 0), (128, "global", 8, 32768)),
    ((16896, 64, 15), (128, "shared", 7, 32768 + 30 * (514 + 260))),
]


@pytest.mark.parametrize("args,want", PLAN_CASES)
def test_decode_plan_for_main_path_shapes(args, want):
    plan = trd.decode_plan_for(*args, sms=132)
    assert (plan["lanes"], plan["tables"], plan["shift"],
            plan["smem"]) == want
    assert plan["tile"] == trd.GRID_TILE


def test_decode_plan_for_spans_and_limits():
    """Lanes halve until every SM has a block (never below 32); a block
    spans the groups its lanes touch, and its tables take the least shift
    that fits the budget, or global memory where none does; bad shapes
    raise."""
    for sms, lanes in ((1, 128), (132, 32), (10**6, 32)):
        assert trd.decode_plan_for(1100, 1, 4, sms)["lanes"] == lanes
    # sg = 3 in 32-lane blocks: a block starting 2 lanes before a group's
    # end spans 12 groups; 12 order-0 rows fit at shift 6 (not 5), 12 x 15
    # context rows at none
    plan = trd.decode_plan_for(96, 32, 0, 132)
    assert (plan["shift"], plan["smem"]) == (6, 8192 + 12 * (1024 + 516))
    assert trd.decode_plan_for(96, 32, 15, 132)["tables"] == "global"
    with pytest.raises(ValueError):
        trd.decode_plan_for(100, 3, 0, 132)


def test_ctx_tables_checked_in_one_readback():
    """_check_tables keeps both checks and their messages; the class LUT
    tensors are made once per (n_ctx, device, dtype)."""
    f = np.full((2, 4, 256), 128, np.int64)
    c = np.concatenate([np.zeros((2, 4, 1), np.int64),
                        np.cumsum(f, 2)[..., :255]], axis=2)
    trc._check_tables(f, c)
    f_bad = f.copy()
    f_bad[1, 2, 7] += 1
    with pytest.raises(ValueError, match="must sum"):
        trc._check_tables(f_bad, c)
    c_bad = c.copy()
    c_bad[0, 3, 9] += 1
    with pytest.raises(ValueError, match="exclusive prefix"):
        trc._check_tables(f, c_bad)
    for n_ctx in (4, 15):
        lut = trc.class_lut_on(n_ctx, "cpu")
        assert lut is trc.class_lut_on(n_ctx, torch.device("cpu"))
        np.testing.assert_array_equal(lut.numpy(), trc.class_lut(n_ctx))
        assert trc.class_lut_on(n_ctx, "cpu", torch.int64).dtype == torch.int64


def test_new_wrappers_do_not_launch_on_the_cpu(grouped):
    counters = (tre.rans_compact_rows, trd.rans_decode_grouped_grid,
                trc.rans_decode_ctx_grid, tre.rans_encode_grouped)
    before = [f.launches for f in counters]
    raw = torch.from_numpy(grouped["le"])
    tre.rans_encode_rows(torch.from_numpy(grouped["syms"]), grouped["ft"],
                         grouped["ct"])
    trd.rans_decode_grouped_grid(raw, torch.from_numpy(grouped["st"]),
                                 grouped["ft"], grouped["ct"], L)
    assert [f.launches for f in counters] == before
    with pytest.raises(ValueError, match="no kernel for device"):
        tre.rans_compact_rows(raw.to("meta"))


# ---------------------------------------------------------------------------
# IPPCodec's planar grid loop and the lane-grid clip composition
# ---------------------------------------------------------------------------

def test_planar_gop_matches_vcf_tpu():
    """4x64x128, gop 4, m 16, s 4 (tests/test_video.py's TestPlanarGridGOP)."""
    frames = make_test_video(4, 64, 128, seed=9)
    kw = dict(mode="ipp", n_frames=4, gop_size=4, me_block=16, search_range=4)
    jc = jvideo.get(vcf_tpu.config.VideoConfig(**kw),
                    vcf_tpu.CodecConfig(entropy="grans"))
    enc_j, dec_j = jc._build_planar_gop(interpret=True)
    planes_j, mvs_j = enc_j(jnp.asarray(frames))
    rec_j = np.asarray(dec_j(planes_j, mvs_j))
    tc = video.get(VideoConfig(**kw), CodecConfig(entropy="grans"), "cpu")
    planes, mvs = tc._gop_encode_grid_batch(torch.from_numpy(frames)[None])
    rec = tc._gop_decode_grid_batch(planes, mvs)
    assert planes.shape == (1, 4, 3, 64, 128) and planes.dtype == torch.uint8
    assert mvs.shape == (1, 3, 4, 8, 2)
    np.testing.assert_array_equal(mvs[0].numpy(), np.asarray(mvs_j))
    _index_rule(planes[0].numpy(), np.asarray(planes_j), MAX_IPP_DIFF_SHARE)
    assert np.sqrt(np.mean((rec[0].numpy() - rec_j) ** 2)) <= 1e-2
    assert torch.equal(rec, tc.last_grid_recon)
    # each decoder reads the other's planes to its own reconstruction
    np.testing.assert_array_equal(
        np.asarray(dec_j(jnp.asarray(planes[0].numpy()), mvs_j)), rec[0].numpy())


def test_lane_grid_clip_matches_vcf_tpu():
    """bench.py's lane-grid composition at 2x64x256: B3 grid ->
    grid_lanes_lmajor -> K1 on lanes.t() -> grid decode .t() -> B4 grid,
    and the wire route (rows -> assemble_stream -> K3 .t()).  vcf_tpu's words come
    from its XLA `finish_stream` on the raw grid (its compacting encodes
    are held above)."""
    n, h, w, b, qss = 2, 64, 256, 8, 32
    frames = np.stack([np.roll(make_test_video(1, h, w, seed=4)[0],
                               (7 * i, 13 * i), (0, 1)) for i in range(n)])
    s_streams = 2048
    cw = jk._chunk_w(w, b)
    mf, mi = jk.static_mat(jcolor.YCOCG_FWD), jk.static_mat(jcolor.YCOCG_INV)
    kw = dict(b=b, qss=qss, offset=128, grid_layout=True)

    planes_j = jax.vmap(lambda fr: jk.fused_cdct_quantize(
        fr, mf, interpret=True, **kw))(jnp.asarray(frames).transpose(0, 3, 1, 2))
    lanes_j = jrans.grid_lanes_lmajor(planes_j, b, s_streams, rows=32, cw=cw)
    fg, cg = jrans.freqs_from_counts(
        np.asarray(jrans.group_histograms(lanes_j.T, b * b)))
    l = lanes_j.shape[0]
    le_j, st_j = jre.pallas_encode_grouped_raw_u8(
        lanes_j, jnp.asarray(fg), jnp.asarray(cg), unroll=1,
        sg=s_streams // 64, interpret=True, lmajor=True)
    w_j, n_j, _ = jre.finish_stream(le_j)
    dec_j = jrd.pallas_decode_grouped_grid(
        le_j, st_j, jnp.asarray(fg), jnp.asarray(cg), l, unroll=1,
        sg=s_streams // 64, interpret=True, lmajor=True)
    rec_j = np.asarray(jax.vmap(lambda fr: jk.fused_dequantize_cdct(
        fr, mi, interpret=True, **kw))(jrans.grid_unlanes_lmajor(
            dec_j, b, (n, 3, h, w), rows=32, cw=cw))).transpose(0, 2, 3, 1)

    px = torch.from_numpy(frames).permute(0, 3, 1, 2)
    planes = tk.fused_cdct_quantize(px, mf, **kw)
    lanes = trans.grid_lanes_lmajor(planes, b, s_streams, rows=32, cw=cw)
    np.testing.assert_array_equal(lanes.numpy(), np.asarray(lanes_j))
    ft, ct = (torch.from_numpy(np.asarray(t).astype(np.int64)) for t in (fg, cg))
    raw, st = tre.rans_encode_grouped(lanes.t(), ft, ct)
    np.testing.assert_array_equal(raw.numpy(), np.asarray(le_j))
    rows, counts, st_r = tre.rans_encode_rows(lanes.t(), ft, ct)
    words, n_words = tre.assemble_stream(rows, counts)
    nw = int(n_words)
    assert nw == int(n_j) and torch.equal(st_r, st)
    np.testing.assert_array_equal(words[:nw].numpy(), np.asarray(w_j)[:nw])
    back = trd.rans_decode_grouped_grid(raw, st, ft, ct, l).t()
    wire = trd.rans_decode_grouped(words[:nw].clone(), st, ft, ct, l,
                                   counts).t()
    assert torch.equal(back, lanes) and torch.equal(wire, lanes)
    rec = tk.fused_dequantize_cdct(trans.grid_unlanes_lmajor(
        back, b, (n, 3, h, w), rows=32, cw=cw), mi, **kw).permute(0, 2, 3, 1)
    d = np.abs(rec.numpy().astype(np.int64) - rec_j)
    assert d.max() <= 1 and (d != 0).mean() < 1e-3
    # the grid path permutes, it does not recompute: its frames are the
    # block-layout path's
    blk = tk.fused_dequantize_cdct(tk.fused_cdct_quantize(px, mf, b=b, qss=qss),
                                   mi, b=b, qss=qss).permute(0, 2, 3, 1)
    assert torch.equal(rec, blk)
