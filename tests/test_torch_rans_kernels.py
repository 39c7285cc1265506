"""The port's rANS kernels K1-K3 (vcf_tpu_torch.ops.cuda) against
vcf_tpu's Pallas kernels.

On the CPU each wrapper runs its plain torch version; the Pallas kernels
run in interpret mode, as vcf_tpu's own tests run them.  Entropy coding
is exact, so every comparison is bit-exact (tolerance 0).  The CUDA
kernels themselves run only on a card (tests/test_torch_cuda.py).
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vcf_tpu.entropy import rans as jrans
from vcf_tpu.ops.pallas import rans_decode as jrd
from vcf_tpu.ops.pallas import rans_encode as jre
from vcf_tpu_torch.entropy import rans as trans
from vcf_tpu_torch.ops.cuda import rans_decode as trd
from vcf_tpu_torch.ops.cuda import rans_encode as tre

# (G, sg, L, unroll of the Pallas kernels): many groups, one group
# (the dense codec), a ragged S=32 dense case (not a multiple of any CUDA
# block size), and S=2048 at the upper end of the small sizes
CASES = [(4, 128, 12, 4), (64, 8, 8, 1), (1, 32, 64, 1), (1, 512, 16, 2),
         (2, 1024, 12, 3)]
IDS = [f"G{g}-sg{sg}-L{l}-u{u}" for g, sg, l, u in CASES]
# step counts around K1's staged symbol tile of T steps (L = 1, T - 1, T,
# T + 1, 2T + 1), S not a multiple of any block's lanes or of 16 (1100,
# 600) or a partial block (144), and sg = 2, far below a block's lanes,
# so one block spans many groups
T = tre.ENCODE_TILE
RAGGED = [(1, 1100, 1, 1), (3, 48, T - 1, 1), (2, 300, T, 4),
          (1, 1100, T + 1, 1), (16, 2, 2 * T + 1, 1)]
RAGGED_IDS = [f"G{g}-sg{sg}-L{l}-u{u}" for g, sg, l, u in RAGGED]


def _case(g, sg, l, seed=0):
    rng = np.random.default_rng(seed)
    s = g * sg
    syms = (rng.integers(0, 250, size=(s, l))
            % rng.integers(2, 250, size=(s, 1))).astype(np.uint8)
    counts = np.stack([np.bincount(syms[i * sg:(i + 1) * sg].reshape(-1),
                                   minlength=256) for i in range(g)])
    freqs_g, cums_g = trans.freqs_from_counts(counts)
    return syms, freqs_g, cums_g


@functools.lru_cache(maxsize=None)
def _pallas_raw(g, sg, l, u):
    """vcf_tpu's raw-grid encode kernel (interpret mode) on `_case`, as
    numpy (raw grid, states); shared by the K1 and K2 tests."""
    syms, fg, cg = _case(g, sg, l, seed=g + l)
    le, st = jre.pallas_encode_grouped_raw(
        jnp.asarray(syms), jnp.asarray(fg), jnp.asarray(cg), unroll=u,
        sg=sg, interpret=True)
    return np.array(le), np.array(st)


def _torch_tables(freqs_g, cums_g):
    return (torch.from_numpy(freqs_g.astype(np.int64)),
            torch.from_numpy(cums_g.astype(np.int64)))


@pytest.mark.parametrize("g,sg,l,u", CASES + RAGGED, ids=IDS + RAGGED_IDS)
def test_encode_raw_grid_matches_pallas(g, sg, l, u):
    syms, fg, cg = _case(g, sg, l, seed=g + l)
    le_j, st_j = _pallas_raw(g, sg, l, u)
    raw, st = tre.rans_encode_grouped(torch.from_numpy(syms),
                                      *_torch_tables(fg, cg))
    assert raw.dtype == torch.int32 and raw.shape == (l, g * sg)
    np.testing.assert_array_equal(raw.numpy(), le_j)
    np.testing.assert_array_equal(st.numpy(), st_j.astype(np.int64))


@pytest.mark.parametrize("g,sg,l,u", CASES, ids=IDS)
def test_compact_matches_pallas_finish_stream(g, sg, l, u):
    le_j, _ = _pallas_raw(g, sg, l, u)
    w_j, n_j, c_j = jre.finish_stream_pallas(
        jnp.asarray(le_j), chunk=2048, sg2=128, radix=2, interpret=True)
    words, n_words, counts = tre.rans_compact(torch.from_numpy(le_j.copy()))
    n = int(n_words)
    assert n == int(n_j)
    np.testing.assert_array_equal(words[:n].numpy(), np.asarray(w_j)[:n])
    np.testing.assert_array_equal(counts.numpy(), np.asarray(c_j))
    assert int(counts.sum()) == n


@pytest.mark.parametrize("g,sg,l,u", CASES, ids=IDS)
def test_decode_matches_pallas_on_same_stream(g, sg, l, u):
    syms, fg, cg = _case(g, sg, l, seed=g + l)
    w, nw, st, counts = jrans.jax_encode_grouped(
        jnp.asarray(syms), jnp.asarray(fg), jnp.asarray(cg), with_counts=True)
    nw = int(nw)
    counts_h = np.asarray(counts)
    cap = min(sg * max(1, -(-int(counts_h.max()) // sg)), g * sg)
    wpad = jnp.concatenate([w[:nw], jnp.zeros(cap + 16, jnp.uint16)])
    win = jrd.build_windows(wpad, counts, cap)
    out_j = jrd.pallas_decode_grouped(win, st, jnp.asarray(fg),
                                      jnp.asarray(cg), l, cap, unroll=u,
                                      sg=sg, interpret=True)
    words = torch.from_numpy(np.array(w[:nw]))
    states = torch.from_numpy(np.asarray(st).astype(np.int64))
    out = trd.rans_decode_grouped(words, states, *_torch_tables(fg, cg), l,
                                  torch.from_numpy(counts_h.astype(np.int64)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(out.numpy(), syms)
    # the dense v0 stream carries no counts: the decoder finds them itself
    out_nc = trd.rans_decode_grouped(words, states, *_torch_tables(fg, cg), l)
    np.testing.assert_array_equal(out_nc.numpy(), syms)


@pytest.mark.parametrize("g,sg,l", [(2, 4, 6), (1, 8, 5)])
def test_plain_versions_match_numpy_oracle(g, sg, l):
    syms, fg, cg = _case(g, sg, l, seed=7)
    words_np, states_np = trans.np_encode_grouped(syms, fg)
    raw, st = tre.rans_encode_grouped(torch.from_numpy(syms),
                                      *_torch_tables(fg, cg))
    words, n_words, _ = tre.rans_compact(raw)
    n = int(n_words)
    np.testing.assert_array_equal(words[:n].numpy(), words_np)
    np.testing.assert_array_equal(st.numpy(), states_np.astype(np.int64))
    out = trd.rans_decode_grouped(words[:n], st, *_torch_tables(fg, cg), l)
    np.testing.assert_array_equal(
        out.numpy(), trans.np_decode_grouped(words_np, states_np, fg,
                                             g * sg, l))


def _encoded(g=4, sg=16, l=8):
    syms, fg, cg = _case(g, sg, l, seed=3)
    raw, st = tre.rans_encode_grouped(torch.from_numpy(syms),
                                      *_torch_tables(fg, cg))
    words, n_words, counts = tre.rans_compact(raw)
    return syms, fg, cg, words[:int(n_words)], st, counts, l


def test_decode_rejects_corrupt_counts():
    _, fg, cg, words, st, counts, l = _encoded()
    bad = counts.clone()
    bad[0] += 1
    with pytest.raises(ValueError, match="counts sidecar"):
        trd.rans_decode_grouped(words, st, *_torch_tables(fg, cg), l, bad)


@pytest.mark.parametrize("cut,match", [(1, "ends before"), (-1, "left over")])
def test_decode_rejects_wrong_stream_length(cut, match):
    _, fg, cg, words, st, _, l = _encoded()
    if cut > 0:
        words = words[:-cut]
    else:
        words = torch.cat([words, words[:1]])
    with pytest.raises(ValueError, match=match):
        trd.rans_decode_grouped(words, st, *_torch_tables(fg, cg), l)


@pytest.mark.parametrize("where", ["first", "mid", "last"])
@pytest.mark.parametrize("delta", [1, -1])
def test_decode_names_first_bad_step(where, delta):
    """A corrupt counts sidecar raises at the first step whose total
    differs, as the kernels report it; a later bad step does not hide
    it."""
    _, fg, cg, words, st, counts, l = _encoded(l=12)
    t = {"first": 0, "mid": l // 2, "last": l - 1}[where]
    bad = counts.clone()
    bad[t] += delta
    if t + 2 < l:
        bad[t + 2] += 5
    with pytest.raises(ValueError, match=rf"counts sidecar \(step {t}\)$"):
        trd.rans_decode_grouped(words, st, *_torch_tables(fg, cg), l, bad)


@pytest.mark.parametrize("cut,match", [(1, "ends before"), (-1, "left over")])
def test_decode_names_step_of_wrong_stream_length(cut, match):
    """A stream cut short raises at the first step whose words end past
    it; a padded one at step L, with or without counts."""
    _, fg, cg, words, st, counts, l = _encoded()
    ends = torch.cumsum(counts, 0)
    if cut > 0:
        words = words[:-cut]
        step = int((ends > words.numel()).nonzero()[0])
    else:
        words = torch.cat([words, words[:1]])
        step = l
    for cnt in (counts, None):
        with pytest.raises(ValueError, match=rf"{match}.*\(step {step}\)$"):
            trd.rans_decode_grouped(words, st, *_torch_tables(fg, cg), l, cnt)


def test_wrappers_check_inputs():
    syms, fg, cg = _case(2, 8, 4)
    ft, ct = _torch_tables(fg, cg)
    with pytest.raises(ValueError, match="uint8"):
        tre.rans_encode_grouped(torch.from_numpy(syms).to(torch.int32), ft, ct)
    with pytest.raises(ValueError, match="groups"):
        tre.rans_encode_grouped(torch.from_numpy(syms[:15]), ft, ct)
    with pytest.raises(ValueError, match="int32"):
        tre.rans_compact(torch.zeros((2, 3), dtype=torch.int64))
    with pytest.raises(ValueError, match="uint16"):
        trd.rans_decode_grouped(torch.zeros(3, dtype=torch.int32),
                                torch.zeros(16, dtype=torch.int64), ft, ct, 4)


def test_launch_encode_takes_contiguous_lanes():
    """K1's launcher reads (L, S) rows: a strided view (the transposed
    (S, L) lanes) or another dtype raises before anything is built."""
    syms = torch.zeros((16, 8), dtype=torch.uint8)
    tab = torch.zeros((1, 256), dtype=torch.int32)
    for bad in (syms.t(), syms.to(torch.int32)):
        with pytest.raises(ValueError, match="contiguous"):
            tre.launch_encode(bad, tab, None, 1, 0)


def test_plain_path_does_not_count_launches():
    before = (tre.rans_encode_grouped.launches, tre.rans_compact.launches,
              trd.rans_decode_grouped.launches)
    _encoded()
    after = (tre.rans_encode_grouped.launches, tre.rans_compact.launches,
             trd.rans_decode_grouped.launches)
    assert before == after
