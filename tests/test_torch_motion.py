"""The port's motion ops (vcf_tpu_torch.ops.motion) and the plain versions
of its SAD and MC kernels against vcf_tpu's, from the same numpy inputs.

vcf_tpu's Pallas kernels run in interpret mode, as its own tests run
them on the CPU.  Tolerances, each with its reason:
* luma: bit-exact (the port evaluates vcf_tpu's float32 FMA chain
  exactly, `ops.color.fma_rows`);
* SADs: rtol 1e-5 — the port sums in float64, exactly, vcf_tpu in
  float32 in an order XLA picks;
* mvs: equal, except at a near-tie, where the two candidates' exact SADs
  are within 1e-5 relative (ROADMAP C6);
* motion compensation: bit-exact (a copy).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vcf_tpu.io.video import test_video as jax_test_video
from vcf_tpu.ops import motion as jm
from vcf_tpu.ops.pallas import mc_kernel as jmc
from vcf_tpu.ops.pallas import sad_kernel as jsad
from vcf_tpu_torch.ops import motion as tm
from vcf_tpu_torch.ops.cuda import mc_kernel as mk
from vcf_tpu_torch.ops.cuda import sad_kernel as sk

NEAR_TIE = 1e-5


def _known_shift():
    """tests/test_video.py's pair: cur[y, x] = ref[y + 3, x - 5], 64x80."""
    rng = np.random.default_rng(0)
    big = rng.integers(0, 255, (80, 96), np.uint8).astype(np.float32)
    return big[8:72, 8:88].copy(), big[11:75, 3:83].copy()


def _video_lumas(n=3, h=96, w=112, seed=7):
    frames = jax_test_video(n, h, w, seed=seed)
    return np.stack([np.asarray(jm.to_luma(jnp.asarray(f))) for f in frames])


def _exact_sad(ref, cur, m, s, by, bx, d):
    """float64 SAD of block (by, bx) of cur against edge-padded ref at d."""
    pad = np.pad(ref.astype(np.float64), s, mode="edge")
    y, x = by * m + s + d[0], bx * m + s + d[1]
    blk = cur[by * m:(by + 1) * m, bx * m:(bx + 1) * m].astype(np.float64)
    return np.abs(blk - pad[y:y + m, x:x + m]).sum()


def _mv_rule(mv_t, mv_j, ref, cur, m, s):
    """mvs equal, or a near-tie of the two candidates."""
    mv_t, mv_j = np.asarray(mv_t), np.asarray(mv_j)
    for by, bx in np.argwhere((mv_t != mv_j).any(-1)):
        a = _exact_sad(ref, cur, m, s, by, bx, mv_t[by, bx])
        b = _exact_sad(ref, cur, m, s, by, bx, mv_j[by, bx])
        assert abs(a - b) <= NEAR_TIE * max(a, b), (by, bx, a, b)


def _sad_rule(sad_t, sad_j):
    np.testing.assert_allclose(np.asarray(sad_t), np.asarray(sad_j),
                               rtol=1e-5, atol=0)


def test_to_luma_matches_vcf_tpu():
    frames = jax_test_video(3, 96, 112)
    rng = np.random.default_rng(3)
    noise = rng.integers(0, 256, (2, 40, 56, 3)).astype(np.uint8)
    for batch in (frames, noise):
        want = np.stack([np.asarray(jm.to_luma(jnp.asarray(f))) for f in batch])
        got = tm.to_luma(torch.from_numpy(batch))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        planar = torch.from_numpy(batch).permute(0, 3, 1, 2).to(torch.float32)
        np.testing.assert_array_equal(
            tm.to_luma(planar, channel_axis=-3).numpy(), want)


def test_full_search_finds_known_shift():
    ref, cur = _known_shift()
    mv, sad = tm.full_search(torch.from_numpy(ref), torch.from_numpy(cur),
                             m=16, s=8)
    assert (mv[1:-1, 1:-1, 0] == 3).all() and (mv[1:-1, 1:-1, 1] == -5).all()
    assert float(sad[1:-1, 1:-1].max()) == 0.0


def _search_cases():
    ref, cur = _known_shift()
    lumas = _video_lumas()
    rng = np.random.default_rng(1)
    same = rng.integers(0, 255, (64, 64), np.uint8).astype(np.float32)
    return {
        "known-shift-s8": (ref, cur, 16, 8),
        "identical-s4": (same, same, 16, 4),
        "video-s8": (lumas[0], lumas[1], 16, 8),
        "video-s4-m8": (lumas[1], lumas[2], 8, 4),
    }


@pytest.mark.parametrize("case", ["known-shift-s8", "identical-s4",
                                  "video-s8", "video-s4-m8"])
@pytest.mark.parametrize("search", ["full", "three_step"])
def test_search_matches_vcf_tpu(case, search):
    ref, cur, m, s = _search_cases()[case]
    jfn = jm.full_search if search == "full" else jm.three_step_search
    tfn = tm.full_search if search == "full" else tm.three_step_search
    mv_j, sad_j = jfn(jnp.asarray(ref), jnp.asarray(cur), m, s)
    mv_t, sad_t = tfn(torch.from_numpy(ref), torch.from_numpy(cur), m, s)
    assert mv_t.dtype == torch.int32 and sad_t.dtype == torch.float32
    if search == "full":
        _mv_rule(mv_t, mv_j, ref, cur, m, s)
    else:   # one path through the steps: a tie early moves the rest
        np.testing.assert_array_equal(mv_t.numpy(), np.asarray(mv_j))
    _sad_rule(sad_t, sad_j)


@pytest.mark.parametrize("search", ["full", "three_step"])
def test_batched_search_equals_per_frame(search):
    """A leading GOP axis (vcf_tpu's vmap) gives each frame's own result,
    at the batched G=2, 32x64 shape of tests/test_pallas.py."""
    rng = np.random.default_rng(0)
    refs = rng.integers(0, 255, (2, 32, 64)).astype(np.float32)
    curs = np.roll(refs, (0, 3, -2), (0, 1, 2))
    tfn = tm.full_search if search == "full" else tm.three_step_search
    mv_b, sad_b = tfn(torch.from_numpy(refs), torch.from_numpy(curs), 16, 4)
    for i in range(2):
        mv, sad = tfn(torch.from_numpy(refs[i]), torch.from_numpy(curs[i]),
                      16, 4)
        assert torch.equal(mv_b[i], mv) and torch.equal(sad_b[i], sad)


def test_compensate_matches_vcf_tpu():
    rng = np.random.default_rng(2)
    big = rng.integers(0, 255, (80, 96, 3)).astype(np.float32)
    ref, cur = big[8:72, 8:88].copy(), big[11:75, 3:83]
    mv = np.broadcast_to(np.asarray([3, -5], np.int32), (4, 5, 2)).copy()
    pred = tm.compensate(torch.from_numpy(ref), torch.from_numpy(mv), 16,
                         pad=8).numpy()
    np.testing.assert_array_equal(pred[16:-16, 16:-16], cur[16:-16, 16:-16])
    refs = rng.integers(0, 255, (2, 96, 112, 3)).astype(np.float32)
    for pad, lim in ((8, 8), (16, 12)):
        mvs = rng.integers(-lim, lim + 1, (2, 6, 7, 2)).astype(np.int32)
        got = tm.compensate(torch.from_numpy(refs), torch.from_numpy(mvs), 16,
                            pad=pad).numpy()
        for i in range(2):
            want = np.asarray(jm.compensate(jnp.asarray(refs[i]),
                                            jnp.asarray(mvs[i]), 16, pad=pad))
            np.testing.assert_array_equal(got[i], want)


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("case", ["known-shift", "video", "batched"])
def test_sad_search_ref_matches_pallas(case, tiled):
    """The kernel's plain version against both Pallas functions it
    replaces, sad_search and sad_search_tiled(tile_h=32)."""
    if case == "known-shift":
        ref, cur = _known_shift()
        refs, curs, m, s = ref[None], cur[None], 16, 8
    elif case == "video":
        lumas = _video_lumas(h=64, w=96)
        refs, curs, m, s = lumas[:2], lumas[1:], 16, 8
    else:
        rng = np.random.default_rng(0)
        refs = rng.integers(0, 255, (2, 32, 64)).astype(np.float32)
        curs = np.roll(refs, (0, 3, -2), (0, 1, 2))
        m, s = 16, 4
    mv_t, sad_t = sk.sad_search(torch.from_numpy(refs),
                                torch.from_numpy(curs), m, s)
    assert sk.sad_search.launches == 0
    for i in range(refs.shape[0]):
        if tiled:
            mv_j, sad_j = jsad.sad_search_tiled(
                jnp.asarray(refs[i]), jnp.asarray(curs[i]), m, s, tile_h=32,
                interpret=True)
        else:
            mv_j, sad_j = jsad.sad_search(jnp.asarray(refs[i]),
                                          jnp.asarray(curs[i]), m, s,
                                          interpret=True)
        _mv_rule(mv_t[i], mv_j, refs[i], curs[i], m, s)
        _sad_rule(sad_t[i], sad_j)


def test_sad_is_independent_of_summation_order():
    """The float64 block SAD is exact: permuting a block's pixels (the same
    permutation in ref and cur) gives the same bits, where a float32 sum
    in another order does not."""
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    lumas = tm.to_luma(torch.from_numpy(frames)).numpy()
    m = 16

    def blocks(x):
        return x.reshape(4, m, 4, m).transpose(0, 2, 1, 3).reshape(16, m * m)

    def unblocks(x):
        return x.reshape(4, 4, m, m).transpose(0, 2, 1, 3).reshape(64, 64)

    ref_b, cur_b = blocks(lumas[0]), blocks(lumas[1])
    _, sad = tm.full_search(torch.from_numpy(lumas[0]),
                            torch.from_numpy(lumas[1]), m, 0)
    f32_sums = set()
    for seed in range(4):
        perm = np.random.default_rng(seed).permutation(m * m)
        ref_p = unblocks(ref_b[:, perm])
        cur_p = unblocks(cur_b[:, perm])
        _, sad_p = tm.full_search(torch.from_numpy(ref_p),
                                  torch.from_numpy(cur_p), m, 0)
        assert torch.equal(sad_p, sad)
        f32_sums.add(np.cumsum(np.abs(cur_b - ref_b)[:, perm], axis=1,
                               dtype=np.float32)[:, -1].tobytes())
    assert len(f32_sums) > 1


def _screen_blocks(kind, m, n_blocks, rng):
    """(a, b) float32 (n_blocks, m * m) block pairs, both multiples of
    2^-27 below 256 (lumas), so the float64 sums of |a - b| are exact."""
    if kind == "integer":
        a, b = (rng.integers(0, 256, (2, n_blocks, m * m)).astype(np.float32))
        return a, b
    px = rng.integers(0, 256, (2, n_blocks * m * m, 3)).astype(np.uint8)
    a, b = tm.to_luma(torch.from_numpy(px)).numpy().reshape(2, n_blocks,
                                                           m * m)
    if kind == "cancellation":
        # b within a few ulp of a (terms of a few 2^-16) among 5% large
        # terms, beside which the float32 sum loses the small ones' bits
        a = np.maximum(a, np.float32(128.0))
        steps = rng.integers(-3, 4, a.shape) * np.float32(2.0 ** -16)
        b = a + steps.astype(np.float32)
        big = rng.random(a.shape) < 0.05
        b[big] = np.float32(0.114)
    return a, b


@pytest.mark.parametrize("kind", ["luma", "integer", "cancellation"])
@pytest.mark.parametrize("m", [4, 8, 16, 32])
def test_sad_screen_bound(m, kind):
    """The float32 screen's bound: the recursive float32 sum F of
    fl(|a - b|) (the kernel's term order, row-major) is within
    screen_bound(m) * S of the exact sum S, and screen_bound(m) is
    (m^2 + 1) u / (1 - (m^2 + 1) u), u = 2^-24, rounded up."""
    from fractions import Fraction

    nu = Fraction(m * m + 1, 2 ** 24)
    g = nu / (1 - nu)
    bound = sk.screen_bound(m)
    assert Fraction(bound) >= g and Fraction(bound) - g < g * 2 ** -50
    a, b = _screen_blocks(kind, m, 4096 // m, np.random.default_rng(m))
    terms = np.abs(a - b)                                     # float32
    f = np.cumsum(terms, axis=1, dtype=np.float32)[:, -1].astype(np.float64)
    exact = np.abs(a.astype(np.float64) - b.astype(np.float64)).sum(axis=1)
    assert np.all(np.abs(f - exact) <= bound * exact)
    if kind != "integer":          # the float32 sums do round here
        assert np.any(f != exact)


@pytest.mark.parametrize("m", [4, 8, 16, 32, 6])
def test_sad_gate_keeps_every_shape_accepted_before(m):
    """Every (m, s) the first kernel design took (its float64 window and
    block in 48 KiB) passes the wrapper's gate on the CPU, which keeps that
    gate; the next range raises.  (On the card the C entry's gate decides;
    tests/test_torch_cuda.py holds it to this one.)"""
    x = torch.zeros((m, m))
    s = 0
    while ((m + 2 * s) ** 2 + m * m) * 8 <= sk.FIRST_DESIGN_SMEM:
        sk._check(x, x, m, s)
        s += 1
    with pytest.raises(ValueError, match="shared memory"):
        sk._check(x, x, m, s)


@pytest.mark.parametrize("m", [4, 8, 16, 32])
def test_sad_fits_is_the_wrappers_gate(m):
    """`fits` (the route's predicate) agrees with `_check` (the wrapper's
    refusal) on both sides of the CPU gate."""
    x = torch.zeros((m, m))
    s = max(s for s in range(200)
            if ((m + 2 * s) ** 2 + m * m) * 8 <= sk.FIRST_DESIGN_SMEM)
    assert sk.fits(m, s, "cpu") and sk.fits(m, s, x.device)
    sk._check(x, x, m, s)
    assert not sk.fits(m, s + 1, "cpu")
    with pytest.raises(ValueError, match="shared memory"):
        sk._check(x, x, m, s + 1)
    with pytest.raises(ValueError, match="no kernel for device"):
        sk.fits(m, s, "meta")


MC_CASES = [(64, 128, 16, 4), (96, 160, 16, 8), (64, 256, 8, 4),
            (32, 96, 4, 3), (64, 128, 32, 8)]


@pytest.mark.parametrize("h,w,m,s", MC_CASES)
def test_mc_plain_versions_match_pallas(h, w, m, s):
    rng = np.random.default_rng(11)
    ref = rng.integers(0, 255, size=(h, w, 3)).astype(np.float32)
    mv = rng.integers(-s, s + 1, size=(h // m, w // m, 2)).astype(np.int32)
    want = np.asarray(jmc.mc_apply(jnp.asarray(ref), jnp.asarray(mv), m, s,
                                   interpret=True))
    got = mk.mc_apply(torch.from_numpy(ref), torch.from_numpy(mv), m)
    np.testing.assert_array_equal(got.numpy(), want)
    planar = np.ascontiguousarray(ref.transpose(2, 0, 1))
    want_p = np.asarray(jmc.mc_apply_planar(jnp.asarray(planar),
                                            jnp.asarray(mv), m, s,
                                            interpret=True))
    got_p = mk.mc_apply_planar(torch.from_numpy(planar), torch.from_numpy(mv),
                               m)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    np.testing.assert_array_equal(
        tm.compensate(torch.from_numpy(ref), torch.from_numpy(mv), m,
                      pad=max(s, 8)).numpy(), want)
    assert mk.mc_apply.launches == 0 and mk.mc_apply_planar.launches == 0


# (m, ref address, out address) -> the kernel's mode: the IPP loops' and
# phase 3c's m = 16 (and m = 4, 8, 32) on aligned frames take the vector
# mode; m % 4 != 0 or a frame off 16-byte alignment the generic mode
MODE_CASES = [
    ((16, 0, 0), "vector"), ((16, 1 << 20, 512), "vector"),
    ((4, 64, 0), "vector"), ((8, 16, 16), "vector"), ((32, 512, 0), "vector"),
    ((12, 0, 0), "vector"), ((5, 0, 0), "generic"), ((6, 0, 0), "generic"),
    ((1, 0, 0), "generic"), ((16, 4, 0), "generic"), ((16, 0, 8), "generic"),
    ((12, 1028, 0), "generic"),
]


@pytest.mark.parametrize("args,want", MODE_CASES)
def test_mc_launch_mode_for_main_path_shapes(args, want):
    """The wrapper's mirror of the C launcher's choice (`vcf_mc_mode`;
    the card tests hold the two equal)."""
    assert mk.launch_mode(*args) == want


def test_mc_edge_mvs_clamp_as_pallas():
    """Boundary blocks pointing out of the frame repeat the edge
    (tests/test_pallas.py's case), with a leading GOP axis."""
    rng = np.random.default_rng(12)
    h, w, m, s = 64, 128, 16, 8
    ref = rng.integers(0, 255, size=(2, h, w, 3)).astype(np.float32)
    mv = np.zeros((2, h // m, w // m, 2), np.int32)
    mv[:, 0, :, 0] = -s
    mv[:, -1, :, 1] = s
    mv[1, :, 0, 1] = -s
    got = mk.mc_apply(torch.from_numpy(ref), torch.from_numpy(mv), m)
    got_p = mk.mc_apply_planar(torch.from_numpy(ref).permute(0, 3, 1, 2),
                               torch.from_numpy(mv), m)
    for i in range(2):
        want = np.asarray(jmc.mc_apply(jnp.asarray(ref[i]), jnp.asarray(mv[i]),
                                       m, s, interpret=True))
        np.testing.assert_array_equal(got[i].numpy(), want)
        np.testing.assert_array_equal(got_p[i].permute(1, 2, 0).numpy(), want)


def test_kernel_wrappers_reject_other_devices():
    meta = torch.empty((2, 32, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        sk.sad_search(meta, meta, 16, 4)
    with pytest.raises(ValueError, match="no kernel for device"):
        mk.mc_apply_planar(torch.empty((3, 32, 32), device="meta"),
                           torch.zeros((2, 2, 2), dtype=torch.int32), 16)
    with pytest.raises(ValueError, match="shared memory"):
        sk.sad_search(torch.zeros(64, 64), torch.zeros(64, 64), 32, 70)
    with pytest.raises(ValueError, match="only on CUDA"):
        sk.count_refined(torch.zeros(64, 64), torch.zeros(64, 64), 32, 4)
