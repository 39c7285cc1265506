"""The port's order-1 context rANS (`cgrans`) against vcf_tpu's.

Covers the context helpers (lane layout, classes, histograms, tables),
the context modes of K1 and K3 (`ops.cuda.rans_ctx`; on the CPU their
plain torch versions) against vcf_tpu's numpy oracle, its XLA scans and
its Pallas kernels in interpret mode, and `CtxRANSCodec` against
vcf_tpu's codec.  Entropy coding is exact: every comparison is
bit-exact (tolerance 0).  The CUDA kernels run only on a card
(tests/test_torch_cuda.py).
"""

import zlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vcf_tpu.entropy import rans as jrans
from vcf_tpu.ops.pallas import rans_ctx as jrc
from vcf_tpu.ops.pallas import rans_decode as jrd
from vcf_tpu.ops.pallas import rans_encode as jre
import vcf_tpu_torch.entropy as tentropy
from vcf_tpu_torch import CodecConfig
from vcf_tpu_torch.entropy import rans as trans
from vcf_tpu_torch.ops.cuda import rans_ctx as trc
from vcf_tpu_torch.ops.cuda import rans_encode as tre

CPU = torch.device("cpu")

# (G, sg, L, n_ctx): groups of a few lanes, and 15 classes with few and
# with more lanes (Pallas interpret mode is slow in G, so G stays small)
CASES = [(8, 4, 12, 4), (4, 8, 12, 15), (2, 32, 8, 15)]
IDS = [f"G{g}-sg{sg}-L{l}-c{c}" for g, sg, l, c in CASES]


def _case(g, sg, l, n_ctx, seed=0):
    """Symbols near 128 with runs (context-correlated, as DCT planes) and
    their (G, n_ctx, 256) tables from vcf_tpu's histogram."""
    rng = np.random.default_rng(seed)
    noise = rng.integers(-6, 7, size=(g * sg, l)) * (
        rng.random((g * sg, l)) < 0.4)
    syms = np.clip(128 + np.cumsum(noise, axis=1) // 2, 0, 255).astype(np.uint8)
    counts = np.asarray(jrans.ctx_group_histograms(jnp.asarray(syms), g, n_ctx))
    fgc, cgc = jrans.ctx_freqs_from_counts(counts)
    return syms, fgc, cgc


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _encode(syms, fgc, cgc):
    raw, states = trc.rans_encode_ctx(torch.from_numpy(syms), _t(fgc), _t(cgc))
    words, n_words, counts = tre.rans_compact(raw)
    n = int(n_words)
    return raw, states, words[:n], counts


# ---------------------------------------------------------------------------
# Context helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,s_streams", [((1, 64, 96, 3), 256),
                                             ((2, 32, 48, 3), 128)])
def test_ctx_lanes_match_vcf_tpu(shape, s_streams):
    rng = np.random.default_rng(1)
    planes = rng.integers(0, 256, size=shape, dtype=np.uint8)
    lanes_j = np.asarray(jrans.subband_lanes_ctx(jnp.asarray(planes), 8,
                                                 s_streams))
    lanes_t = trans.subband_lanes_ctx(torch.from_numpy(planes), 8, s_streams)
    np.testing.assert_array_equal(lanes_t.numpy(), lanes_j)
    # lane-major, not subband_lanes' layout
    assert not np.array_equal(
        lanes_j, trans.subband_lanes(torch.from_numpy(planes), 8,
                                     s_streams).numpy())
    np.testing.assert_array_equal(
        trans.subband_unlanes_ctx(lanes_t, 8, shape).numpy(), planes)


@pytest.mark.parametrize("n_ctx", [4, 15])
def test_ctx_classes_match_vcf_tpu(n_ctx):
    prev = np.arange(256, dtype=np.uint8)
    want = np.asarray(jrans.ctx_class_n(jnp.asarray(prev), n_ctx))
    got = trans.ctx_class_n(torch.from_numpy(prev), n_ctx).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(trc.class_lut(n_ctx), want)
    if n_ctx == 4:
        np.testing.assert_array_equal(
            trans.ctx_class(torch.from_numpy(prev)).numpy(),
            np.asarray(jrans.ctx_class(jnp.asarray(prev))))


@pytest.mark.parametrize("n_ctx", [4, 15])
def test_ctx_histograms_and_tables_match_vcf_tpu(n_ctx):
    syms, fgc, cgc = _case(8, 16, 24, n_ctx, seed=3)
    counts_t = trans.ctx_group_histograms(torch.from_numpy(syms), 8, n_ctx)
    counts_j = np.asarray(jrans.ctx_group_histograms(jnp.asarray(syms), 8,
                                                     n_ctx))
    np.testing.assert_array_equal(counts_t.numpy(), counts_j)
    for mine, theirs in zip(trans.ctx_freqs_from_counts(counts_t.numpy()),
                            (fgc, cgc)):
        assert mine.dtype == np.uint32
        np.testing.assert_array_equal(mine, theirs)


# ---------------------------------------------------------------------------
# Context modes of K1 (+ K2) and K3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g,sg,l,n_ctx", CASES, ids=IDS)
def test_encode_matches_numpy_oracle_and_xla(g, sg, l, n_ctx):
    syms, fgc, cgc = _case(g, sg, l, n_ctx, seed=g + l)
    _, states, words, counts = _encode(syms, fgc, cgc)
    w_np, x_np = jrans.np_encode_ctx(syms, fgc)
    w_port, x_port = trans.np_encode_ctx(syms, fgc)
    np.testing.assert_array_equal(w_port, w_np)
    np.testing.assert_array_equal(x_port, x_np)
    np.testing.assert_array_equal(words.numpy(), w_np)
    np.testing.assert_array_equal(states.numpy(), x_np.astype(np.int64))
    wx, nx, sx, cx = jrans.jax_encode_ctx(jnp.asarray(syms), jnp.asarray(fgc),
                                          jnp.asarray(cgc))
    np.testing.assert_array_equal(words.numpy(), np.asarray(wx)[:int(nx)])
    np.testing.assert_array_equal(counts.numpy(), np.asarray(cx))


# (G, sg, L, n_ctx, lmajor, unroll): step counts around K1's staged
# symbol tile of T steps (L = 1, T - 1, T, T + 1, 2T + 1; a tile's lowest
# step takes its previous symbol from the staged row below it), S not a
# multiple of any block's lanes or of 16 (1100, 600) or a partial block
# (144), and sg = 2 (a block spans many groups; on the card their 4-class
# tables pass 48 KiB and are read from global memory)
T = tre.ENCODE_TILE
ENCODE_CASES = [(4, 8, 12, 4, False, 4), (8, 4, 12, 4, True, 4),
                (2, 32, 8, 15, True, 4), (1, 1100, 1, 4, True, 1),
                (3, 48, T - 1, 15, False, 1), (2, 300, T, 4, True, 4),
                (1, 1100, T + 1, 15, True, 1), (16, 2, 2 * T + 1, 4, True, 1)]


@pytest.mark.parametrize("g,sg,l,n_ctx,lmajor,u", ENCODE_CASES,
                         ids=["-".join(map(str, c[:5])) for c in ENCODE_CASES])
def test_encode_raw_grid_matches_pallas(g, sg, l, n_ctx, lmajor, u):
    """Both TPU context encode kernels (interpret mode) give the plain
    version's raw grid and states; finish_stream_pallas gives K2's
    words."""
    syms, fgc, cgc = _case(g, sg, l, n_ctx, seed=2 * g + l)
    raw, states, words, _ = _encode(syms, fgc, cgc)
    fj, cj = jnp.asarray(fgc), jnp.asarray(cgc)
    s_in = jnp.asarray(syms.T.copy() if lmajor else syms)
    le, st = jrc.pallas_encode_ctx_raw_u8(s_in, fj, cj, unroll=u, sg=sg,
                                          interpret=True, lmajor=lmajor)
    np.testing.assert_array_equal(raw.numpy(), np.asarray(le))
    np.testing.assert_array_equal(states.numpy(),
                                  np.asarray(st).astype(np.int64))
    if n_ctx == 4:      # the packed-class kernel has 4 classes only
        le2, st2 = jrc.pallas_encode_ctx_raw(jnp.asarray(syms), fj, cj,
                                             unroll=u, sg=sg, interpret=True)
        np.testing.assert_array_equal(raw.numpy(), np.asarray(le2))
        np.testing.assert_array_equal(np.asarray(st2), np.asarray(st))
    # finish_stream_pallas cuts the grid into two chunks of whole rows of
    # sg2 entries; the ragged grids do not split so
    sg2 = 64 if sg * g >= 128 else 32
    if (g * sg * l) % (2 * sg2) == 0:
        wp, nwp, _ = jre.finish_stream_pallas(le, chunk=g * sg * l // 2,
                                              sg2=sg2, radix=2,
                                              interpret=True)
        np.testing.assert_array_equal(words.numpy(),
                                      np.asarray(wp)[:int(nwp)])


@pytest.mark.parametrize("g,sg,l,n_ctx", CASES, ids=IDS)
def test_decode_matches_xla_and_pallas(g, sg, l, n_ctx):
    syms, fgc, cgc = _case(g, sg, l, n_ctx, seed=3 * g + l)
    _, states, words, counts = _encode(syms, fgc, cgc)
    out = trc.rans_decode_ctx(words, states, _t(fgc), _t(cgc), l, counts)
    np.testing.assert_array_equal(out.numpy(), syms)
    fj, cj = jnp.asarray(fgc), jnp.asarray(cgc)
    st_j = jnp.asarray(states.numpy().astype(np.uint32))
    wpad = np.concatenate([words.numpy(), np.zeros(g * sg + 16, np.uint16)])
    np.testing.assert_array_equal(
        np.asarray(jrans.jax_decode_ctx(jnp.asarray(wpad), st_j, fj, cj, l)),
        out.numpy())
    cap = min(sg * max(1, -(-int(counts.max()) // sg)), g * sg)
    wpad = jnp.asarray(np.concatenate(
        [words.numpy(), np.zeros(cap + g * sg + 16, np.uint16)]))
    win = jrd.build_windows(wpad, jnp.asarray(counts.numpy()), cap)
    np.testing.assert_array_equal(
        np.asarray(jrc.pallas_decode_ctx(win, st_j, fj, cj, l, cap, unroll=4,
                                         sg=sg, interpret=True)),
        out.numpy())


def test_decode_rejects_corrupt_stream():
    g, sg, l, n_ctx = 4, 8, 12, 4
    syms, fgc, cgc = _case(g, sg, l, n_ctx)
    _, states, words, counts = _encode(syms, fgc, cgc)
    bad = counts.clone()
    bad[1] += 1
    bad[2] -= 1
    with pytest.raises(ValueError, match="counts sidecar"):
        trc.rans_decode_ctx(words, states, _t(fgc), _t(cgc), l, bad)
    with pytest.raises(ValueError, match="stream ends"):
        trc.rans_decode_ctx(words[:-1].clone(), states, _t(fgc), _t(cgc), l)
    with pytest.raises(ValueError, match="left over"):
        trc.rans_decode_ctx(torch.cat([words, words[:1]]), states, _t(fgc),
                            _t(cgc), l)


@pytest.mark.parametrize("step", [0, 5, 11])
def test_decode_names_first_bad_step(step):
    """The context decode raises at the first step whose total differs
    from the counts sidecar, as the kernels report it."""
    g, sg, l, n_ctx = 4, 8, 12, 15
    syms, fgc, cgc = _case(g, sg, l, n_ctx, seed=4)
    _, states, words, counts = _encode(syms, fgc, cgc)
    bad = counts.clone()
    bad[step] += 1
    bad[-1] -= 1 if step < l - 1 else 0
    with pytest.raises(ValueError,
                       match=rf"counts sidecar \(step {step}\)$"):
        trc.rans_decode_ctx(words, states, _t(fgc), _t(cgc), l, bad)


def test_tables_are_validated():
    syms, fgc, cgc = _case(4, 8, 12, 4)
    s = torch.from_numpy(syms)
    bad = fgc.copy()
    bad[0, 1, 7] += 1
    with pytest.raises(ValueError, match="sum"):
        trc.rans_encode_ctx(s, _t(bad), _t(cgc))
    bad = cgc.copy()
    bad[2, 0, 9] += 1
    with pytest.raises(ValueError, match="prefix"):
        trc.rans_encode_ctx(s, _t(fgc), _t(bad))
    with pytest.raises(ValueError, match="n_ctx"):
        trc.rans_encode_ctx(s, _t(fgc[:, :3]), _t(cgc[:, :3]))


# ---------------------------------------------------------------------------
# CtxRANSCodec against vcf_tpu's
# ---------------------------------------------------------------------------

def _runs_planes(seed, sigma):
    """(1, 128, 192, 3) u8 planes of x-runs: strong left-neighbour
    correlation in the context layout (vcf_tpu's test input)."""
    rng = np.random.default_rng(seed)
    runs = np.repeat((128 + rng.normal(0, sigma, size=(3, 512))).clip(0, 255),
                     64, axis=1)[:, :24576]
    return runs.reshape(3, 128, 192).transpose(1, 2, 0)[None].astype(np.uint8)


def _pair(n_ctx, block_size=8, force=True):
    jc = jrans.CtxRANSCodec(block_size=block_size, n_ctx=n_ctx)
    tc = trans.CtxRANSCodec(block_size=block_size, n_ctx=n_ctx, device=CPU)
    if force:   # the context path at test sizes
        jc.MIN_SYMBOLS = 0
        tc.MIN_SYMBOLS = 0
    return jc, tc


def _same_bytes_and_roundtrip(jc, tc, arr):
    pj, sj = jc.encode(arr)
    pt, st = tc.encode(arr)
    assert pt == pj
    assert st == sj
    np.testing.assert_array_equal(tc.decode(pj, sj), arr)
    np.testing.assert_array_equal(np.asarray(jc.decode(pt, st)), arr)
    return st["cgrans_model"]


@pytest.mark.parametrize("n_ctx,block_size,sigma", [(4, 8, 3), (15, 4, 20)])
def test_codec_bytes_identical(n_ctx, block_size, sigma):
    """The context path (sidecar v2) for 4 classes and, with 4x4 blocks
    (16 groups), 15 classes."""
    jc, tc = _pair(n_ctx, block_size)
    blob = _same_bytes_and_roundtrip(jc, tc, _runs_planes(6, sigma))
    assert blob[0] == 2 and blob[1] == n_ctx


@pytest.mark.parametrize("what", ["small", "uint16", "min_symbols"])
def test_codec_delegates_to_order0(what):
    """Version-0 sidecars: inputs that cannot be grouped (too small, or
    uint16) and groupable inputs under MIN_SYMBOLS wrap the grans
    sidecar, byte for byte."""
    rng = np.random.default_rng(5)
    if what == "small":
        arr = rng.integers(0, 255, size=(16, 24, 3)).astype(np.uint8)
    elif what == "uint16":
        arr = (rng.integers(0, 700, size=(40, 24, 3)) ** 1.3).astype(np.uint16)
    else:
        arr = _runs_planes(7, 3)
    jc, tc = _pair(4, force=False)
    assert _same_bytes_and_roundtrip(jc, tc, arr)[0] == 0


def test_codec_rejects_corrupt_counts_sidecar():
    jc, tc = _pair(4)
    payload, side = tc.encode(_runs_planes(6, 3))
    blob = bytearray(side["cgrans_model"])
    # v2 layout: version, n_ctx, S, L, n_words, ndim, shape, len, counts
    off = 2 + 13 + 4 * 4
    (cz_len,) = np.frombuffer(bytes(blob[off:off + 4]), "<u4")
    counts = np.frombuffer(zlib.decompress(bytes(blob[off + 4:off + 4 + cz_len])),
                           "<u4").copy()
    counts[0] += 1
    counts[1] -= 1
    cz = zlib.compress(counts.astype("<u4").tobytes(), 9)
    bad = bytes(blob[:off]) + np.uint32(len(cz)).tobytes() + cz + \
        bytes(blob[off + 4 + cz_len:])
    with pytest.raises(ValueError, match="counts sidecar"):
        tc.decode(payload, {"cgrans_model": bad})


def test_registry_builds_cgrans():
    codec = tentropy.get("cgrans", CodecConfig(context_classes=15), device=CPU)
    assert isinstance(codec, tentropy.CtxRANSCodec)
    assert codec.n_ctx == 15 and codec.b == 8
    with pytest.raises(ValueError, match="n_ctx"):
        trans.CtxRANSCodec(n_ctx=5, device=CPU)
