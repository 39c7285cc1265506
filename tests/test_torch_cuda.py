"""Card-only checks of the port: the CUDA kernels K1-K3 (and their
context modes), B1-B4 and the motion kernels (SAD search, motion
compensation) against their plain torch versions, and the Codec (DCT and
DWT), entropy codecs, BatchCodec, IIICodec and IPPCodec on CUDA against
the same on the CPU (entropy bytes identical on identical index planes).

The kernels have no CPU mode, so every test here is marked `cuda` and
skips without a card.  The file imports neither JAX nor vcf_tpu, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: K1-K3 and their context modes bit-exact against their plain
versions (K3 with counts runs its look-back kernel, without counts its
one-block kernel; a corrupt stream raises the plain version's error); the DWT's subbands equal the CPU's (the float32 FMA chain is
evaluated exactly on both); B1/B3
indexes and the codecs' indexes follow the +-1 rule (a float32 sum taken
in another order moves an index by at most 1, on at most 0.01% of
entries); B2 planes within 1e-3 absolute; decoded pixels from identical
planes d.max() <= 1 on < 0.1% of entries; rmse agrees to 3 decimals.
The SAD kernel's float32 screen keeps every minimiser and its float64
sums are exact, so its mvs and SADs equal the plain version's in both
modes (block-size instances and the generic kernel); motion compensation
is a copy, bit-exact.  The luma kernel equals `ops.color.fma_rows`'s
chain bit for bit: on every RGB triple and on half-integer pixels.  The
DWT level kernels equal the plain torch chain (`ops.dwt.analyze_level_ref`
/ `synthesize_level_ref`): bands bit for bit, synthesis under ==.
"""

import ctypes
import functools

import numpy as np
import pytest
import torch

import vcf_tpu_torch.entropy as entropy
from vcf_tpu_torch import Codec, CodecConfig, CodeStream, metrics, video
from vcf_tpu_torch.config import VideoConfig
from vcf_tpu_torch.entropy import rans
from vcf_tpu_torch.io import test_image as make_test_image
from vcf_tpu_torch.io import test_video as make_test_video
from vcf_tpu_torch.ops import color as color_ops
from vcf_tpu_torch.ops import dct as dct_ops
from vcf_tpu_torch.ops import motion
from vcf_tpu_torch.ops.cuda import _build
from vcf_tpu_torch.ops.cuda import dct_kernel as dk
from vcf_tpu_torch.ops.cuda import dwt_ends as dwe
from vcf_tpu_torch.ops.cuda import dwt_kernel as dwk
from vcf_tpu_torch.ops.cuda import luma_kernel as lk
from vcf_tpu_torch.ops.cuda import mc_kernel as mk
from vcf_tpu_torch.ops import dwt as dwt_ops
from vcf_tpu_torch.ops.cuda import rans_ctx as rc
from vcf_tpu_torch.ops.cuda import rans_decode as rd
from vcf_tpu_torch.ops.cuda import rans_encode as re_
from vcf_tpu_torch.ops.cuda import sad_kernel as sk
from vcf_tpu_torch.parallel import BatchCodec

pytestmark = pytest.mark.cuda

# (G, sg, L): subband groups, one group, the ragged dense S=32 case,
# and a single lane group larger than one CUDA block
CASES = [(4, 128, 12), (64, 8, 8), (1, 32, 64), (1, 512, 16), (2, 1024, 12)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _case(g, sg, l, seed):
    rng = np.random.default_rng(seed)
    syms = (rng.integers(0, 250, size=(g * sg, l))
            % rng.integers(2, 250, size=(g * sg, 1))).astype(np.uint8)
    counts = np.stack([np.bincount(syms[i * sg:(i + 1) * sg].reshape(-1),
                                   minlength=256) for i in range(g)])
    return syms, *rans.freqs_from_counts(counts)


@pytest.mark.parametrize("g,sg,l", CASES)
def test_kernels_match_plain_versions(dev, g, sg, l):
    syms, fg, cg = _case(g, sg, l, seed=g + l)
    s = torch.from_numpy(syms).to(dev)
    ft = torch.from_numpy(fg.astype(np.int64)).to(dev)
    ct = torch.from_numpy(cg.astype(np.int64)).to(dev)
    raw, st = re_.rans_encode_grouped(s, ft, ct)
    raw_p, st_p = re_.rans_encode_grouped_ref(s, ft, ct)
    assert torch.equal(raw, raw_p) and torch.equal(st, st_p)
    words, n_words, counts = re_.rans_compact(raw)
    words_p, n_p, counts_p = re_.rans_compact_ref(raw)
    n = int(n_words)
    assert n == int(n_p) and torch.equal(counts, counts_p)
    assert torch.equal(words[:n], words_p[:n])
    words = words[:n].clone()
    assert torch.equal(rd.rans_decode_grouped(words, st, ft, ct, l, counts), s)
    assert torch.equal(rd.rans_decode_grouped(words, st, ft, ct, l), s)


def test_kernel_decode_rejects_corrupt_stream(dev):
    syms, fg, cg = _case(4, 16, 8, seed=3)
    ft = torch.from_numpy(fg.astype(np.int64)).to(dev)
    ct = torch.from_numpy(cg.astype(np.int64)).to(dev)
    raw, st = re_.rans_encode_grouped(torch.from_numpy(syms).to(dev), ft, ct)
    words, n_words, counts = re_.rans_compact(raw)
    words = words[:int(n_words)].clone()
    bad = counts.clone()
    bad[0] += 1
    with pytest.raises(ValueError, match="counts sidecar"):
        rd.rans_decode_grouped(words, st, ft, ct, 8, bad)
    with pytest.raises(ValueError, match="ends before"):
        rd.rans_decode_grouped(words[:-1].clone(), st, ft, ct, 8)


# (G, sg, L) for K3's look-back kernel and K2's one pass: S not a
# multiple of 128 (1100, 600) nor of K2's 4096-entry tile (tiles cross
# rows: 15000, 1100), sg < 128 (a block spans many groups), sg = 1024,
# L = 1, and S = 65536
LOOKBACK_CASES = [(1, 1100, 5), (3, 5000, 4), (64, 8, 8), (2, 1024, 12),
                  (2, 300, 1), (64, 1024, 3)]


def _tables(dev, fg, cg):
    return (torch.from_numpy(fg.astype(np.int64)).to(dev),
            torch.from_numpy(cg.astype(np.int64)).to(dev))


@pytest.mark.parametrize("g,sg,l", LOOKBACK_CASES)
def test_lookback_decode_and_one_pass_compact(dev, g, sg, l):
    syms, fg, cg = _case(g, sg, l, seed=g * sg + l)
    s = torch.from_numpy(syms).to(dev)
    ft, ct = _tables(dev, fg, cg)
    raw, st = re_.rans_encode_grouped(s, ft, ct)
    before = re_.rans_compact.launches
    words, n_words, counts = re_.rans_compact(raw)
    assert re_.rans_compact.launches == before + 1
    words_p, n_p, counts_p = re_.rans_compact_ref(raw)
    n = int(n_words)
    assert n == int(n_p) and torch.equal(counts, counts_p)
    assert torch.equal(words[:n], words_p[:n])
    words = words[:n].clone()
    tab = re_.pack_tables(ft, ct, dev)
    out, err = rd.launch_decode(words, st, tab, None, counts, l, g, 0)
    assert err.tolist() == [0, 0] and torch.equal(out.t(), s)
    # counts=None: the one-block kernel
    out1, err1 = rd.launch_decode(words, st, tab, None, None, l, g, 0)
    assert err1.tolist() == [0, 0] and torch.equal(out1, out)


# (G, sg, L) for K1's staged tiles of T steps: L = 1, T - 1, T, T + 1,
# 2T + 1; S = 1100 (not a multiple of any block's lanes, nor of 16: plain
# byte loads), a partial block (144), S = 600; sg = 2 far below a block
# (one block spans many groups: S = 32 and, with 128-lane blocks, 16896,
# whose tables pass 48 KiB in both modes and are read from global
# memory); the DWT grid's groups (sg = 512)
T = re_.ENCODE_TILE
K1_CASES = [(1, 1100, 1), (1, 1100, T - 1), (1, 1100, T), (1, 1100, T + 1),
            (1, 1100, 2 * T + 1), (3, 48, T - 1), (2, 300, T),
            (16, 2, 2 * T + 1), (8448, 2, T + 1), (17, 512, 2 * T + 1)]


def _k1_case(g, sg, l, n_ctx, seed):
    """Symbols and (G, 256) or (G, n_ctx, 256) tables, tiled from those
    of at most 4 groups (every symbol has a frequency: min_all)."""
    rng = np.random.default_rng(seed)
    syms = rng.integers(0, 256, size=(g * sg, l)).astype(np.uint8)
    k = min(g, 4)
    if n_ctx:
        counts = rans.ctx_group_histograms(
            torch.from_numpy(syms[:k * sg]), k, n_ctx).numpy()
        fg, cg = rans.ctx_freqs_from_counts(counts)
    else:
        fg, cg = rans.freqs_from_counts(np.stack([np.bincount(
            syms[i * sg:(i + 1) * sg].reshape(-1), minlength=256)
            for i in range(k)]))
    return syms, np.resize(fg, (g, *fg.shape[1:])), np.resize(
        cg, (g, *cg.shape[1:]))


@pytest.mark.parametrize("n_ctx", [0, 4, 15])
@pytest.mark.parametrize("g,sg,l", K1_CASES)
def test_encode_kernel_ragged_shapes(dev, g, sg, l, n_ctx):
    """K1 in both modes against its plain version around its tile size,
    through the wrapper and through launch_encode on a misaligned (L, S)
    view (plain byte loads); the launch plan is the documented one."""
    from vcf_tpu_torch.ops.cuda import _build

    assert _build.load().vcf_rans_encode_tile() == T
    syms, fg, cg = _k1_case(g, sg, l, n_ctx, seed=g + sg + l + n_ctx)
    s = torch.from_numpy(syms).to(dev)
    ft, ct = _tables(dev, fg, cg)
    enc, ref = ((rc.rans_encode_ctx, rc.rans_encode_ctx_ref) if n_ctx
                else (re_.rans_encode_grouped, re_.rans_encode_grouped_ref))
    before = enc.launches
    raw, st = enc(s, ft, ct)
    raw_p, st_p = ref(s, ft, ct)
    assert enc.launches == before + 1
    assert torch.equal(raw, raw_p) and torch.equal(st, st_p)
    buf = torch.empty(g * sg * l + 3, dtype=torch.uint8, device=dev)
    sym_l = buf[3:].view(l, g * sg)
    sym_l.copy_(s.t())
    if n_ctx:
        tab = re_.pack_tables(ft.reshape(-1, 256), ct.reshape(-1, 256), dev)
        lut = torch.from_numpy(rc.class_lut(n_ctx)).to(dev)
    else:
        tab, lut = re_.pack_tables(ft, ct, dev), None
    raw2, st2 = re_.launch_encode(sym_l, tab, lut, g, n_ctx)
    assert torch.equal(raw2, raw_p) and torch.equal(re_.i32_as_u32(st2), st_p)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lanes = 128
    while lanes > 32 and -(-g * sg // lanes) < sms:
        lanes //= 2
    span = min(g, -(-lanes // sg) + 1)
    want = "global" if span * max(n_ctx, 1) * 1024 > 48 * 1024 else "shared"
    assert re_.encode_plan(g * sg, g, n_ctx) == (lanes, want)


def test_compact_and_decode_steps_without_words(dev):
    """Lanes that mostly repeat one symbol renormalize rarely: steps with
    no word, and a grid with no flag at all (n_words = 0)."""
    rng = np.random.default_rng(2)
    syms = np.where(rng.random((192, 48)) < 0.03,
                    rng.integers(0, 256, (192, 48)), 0).astype(np.uint8)
    fg, cg = rans.freqs_from_counts(np.stack([np.bincount(
        syms[i * 64:(i + 1) * 64].reshape(-1), minlength=256)
        for i in range(3)]))
    ft, ct = _tables(dev, fg, cg)
    s = torch.from_numpy(syms).to(dev)
    raw, st = re_.rans_encode_grouped(s, ft, ct)
    words, n_words, counts = re_.rans_compact(raw)
    assert bool((counts == 0).any()) and bool((counts > 0).any())
    words = words[:int(n_words)].clone()
    assert torch.equal(rd.rans_decode_grouped(words, st, ft, ct, 48, counts),
                       s)
    w0, n0, c0 = re_.rans_compact(raw & 0xFFFF)
    assert int(n0) == 0 and not bool(c0.any())


def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("n_ctx", [0, 4, 15])
def test_lookback_decode_names_first_bad_step(dev, n_ctx):
    """Corrupt counts at steps 0, mid and L-1 (up and down), and words cut
    short or padded: the look-back kernel raises the plain version's
    ValueError, naming the same first bad step, and does not hang."""
    g, sg, l = 4, 300, 16
    if n_ctx:
        syms, fg, cg = _ctx_case(g, sg, l, n_ctx, seed=5)
        encode, decode = rc.rans_encode_ctx, rc.rans_decode_ctx
        plain = rc.rans_decode_ctx_ref
    else:
        syms, fg, cg = _case(g, sg, l, seed=5)
        encode, decode = re_.rans_encode_grouped, rd.rans_decode_grouped
        plain = rd.rans_decode_grouped_ref
    ft, ct = _tables(dev, fg, cg)
    raw, st = encode(torch.from_numpy(syms).to(dev), ft, ct)
    words, n_words, counts = re_.rans_compact(raw)
    words = words[:int(n_words)].clone()
    for t in (0, l // 2, l - 1):
        for delta in (1, -1):
            bad = counts.clone()
            bad[t] += delta
            want = _message(lambda: plain(words, st, ft, ct, l, bad))
            assert want.endswith(f"counts sidecar (step {t})")
            assert _message(lambda: decode(words, st, ft, ct, l, bad)) == want
    for wv, match in ((words[:-1].clone(), "ends before"),
                      (words[:len(words) // 3].clone(), "ends before"),
                      (torch.cat([words, words[:2]]), "left over")):
        want = _message(lambda: plain(wv, st, ft, ct, l, counts))
        assert match in want
        assert _message(lambda: decode(wv, st, ft, ct, l, counts)) == want
    torch.cuda.synchronize()


def test_codec_on_cuda_matches_cpu(dev):
    img = make_test_image(256, 256, seed=1)
    gpu = Codec(CodecConfig(entropy="grans"), device=dev)
    cpu = Codec(CodecConfig(entropy="grans"), device="cpu")

    def indexes(codec):
        x = torch.from_numpy(img).to(codec.device).to(torch.float32)
        k = codec._quantize(codec._analyze(dct_ops.pad_centered(x, 8)))[0]
        return k.cpu().numpy().astype(np.int64)

    d = np.abs(indexes(gpu) - indexes(cpu))
    assert d.max() <= 1 and np.count_nonzero(d) <= 1e-4 * d.size
    cs = gpu.encode(img)
    assert cs["grans_model"][0] == 2
    if not d.any():
        assert cs.to_bytes() == cpu.encode(img).to_bytes()
    rec = gpu.decode(CodeStream.from_bytes(cs.to_bytes()))
    assert abs(metrics.rmse(img, rec) - metrics.rmse(img, cpu.decode(cs))) \
        < 1e-3


@pytest.mark.parametrize("name,shape,dtype", [
    ("grans", (2, 128, 256, 3), np.uint8),    # grouped lanes, batch
    ("grans", (96, 112, 3), np.uint8),        # dense fallback, S=32
    ("rans", (61, 45, 3), np.uint16),         # two u8 passes, ragged S
])
def test_entropy_codecs_on_cuda_match_cpu(dev, name, shape, dtype):
    rng = np.random.default_rng(11)
    arr = np.clip(128 + rng.laplace(0, 2.0, size=shape), 0,
                  np.iinfo(dtype).max).astype(dtype)
    gpu, cpu = entropy.get(name, device=dev), entropy.get(name, device="cpu")
    payload, side = gpu.encode(arr)
    assert (payload, side) == cpu.encode(arr)
    assert np.array_equal(gpu.decode(payload, side), arr)


def _index_rule(got, want):
    d = (got.to(torch.int64) - want.to(torch.int64)).abs()
    assert int(d.max()) <= 1
    assert int((d != 0).sum()) <= 1e-4 * d.numel()


def _pixel_rule(got, want):
    d = np.abs(np.asarray(got).astype(np.int64) - np.asarray(want))
    assert d.max() <= 1 and (d != 0).mean() < 1e-3


# (N, H, W, b, qss, off): odd shapes, a ragged last column strip (W not a
# multiple of the kernels' 1024 / b columns), rows that are not 16-byte
# aligned (W = 40, 20, 136, 18, 1030), both steps, every block size (both
# kernels have an instance for each b), and inputs whose storage starts
# `off` elements into their buffer (a u8 input 1 byte in, an f32 input 1
# element in: no run is 16-byte aligned)
DCT_CASES = [(2, 24, 40, 8, 32, 0), (1, 8, 20, 4, 24, 0),
             (3, 16, 136, 8, 24, 0), (1, 32, 288, 4, 32, 0),
             (1, 8, 18, 2, 24, 0), (2, 32, 96, 16, 32, 0),
             (1, 64, 160, 32, 24, 0), (1, 4, 1030, 1, 32, 0),
             (2, 32, 256, 8, 32, 1), (1, 16, 1920, 8, 24, 1)]


def _at_offset(x: torch.Tensor, off: int) -> torch.Tensor:
    """x's values in a tensor whose storage starts `off` elements into a
    larger buffer (so its data pointer is misaligned for off > 0)."""
    buf = torch.empty(x.numel() + off, dtype=x.dtype, device=x.device)
    y = buf[off:].view(x.shape)
    y.copy_(x)
    return y


@pytest.mark.parametrize("n,h,w,b,qss,off", DCT_CASES)
def test_dct_kernels_match_plain_versions(dev, n, h, w, b, qss, off):
    rng = np.random.default_rng(h + w)
    px = _at_offset(torch.from_numpy(rng.integers(0, 256, (n, 3, h, w))
                                     .astype(np.uint8)).to(dev), off)
    mf = dk.static_mat(color_ops.YCRCB_FWD)
    mi = dk.static_mat(color_ops.YCRCB_INV)
    k = dk.fused_cdct_quantize(px, mf, b=b, qss=qss)
    _index_rule(k, dk.fused_cdct_quantize_ref(px, mf, b=b, qss=qss))
    pix = dk.fused_dequantize_cdct(k, mi, b=b, qss=qss)
    _pixel_rule(pix.cpu(), dk.fused_dequantize_cdct_ref(k, mi, b=b,
                                                        qss=qss).cpu())
    planes = _at_offset(torch.from_numpy(rng.normal(0, 80, (n, 3, h, w))
                                         .astype(np.float32)).to(dev), off)
    for perceptual in (False, True):
        kw = dict(b=b, qss=qss, perceptual=perceptual)
        k1 = dk.fused_dct_quantize(planes, **kw)
        _index_rule(k1, dk.fused_dct_quantize_ref(planes, **kw))
        x = dk.fused_dequantize_idct(k1, **kw)
        torch.testing.assert_close(x, dk.fused_dequantize_idct_ref(k1, **kw),
                                   rtol=0, atol=1e-3)
        # (C, H, W) without the frame axis takes the same kernel
        assert torch.equal(dk.fused_dct_quantize(planes[0], **kw), k1[0])
    torch.cuda.synchronize()


@pytest.mark.parametrize("kw", [dict(), dict(color="none"),
                                dict(perceptual=True), dict(use_pallas=False),
                                dict(color="cdct", qss=24)],
                         ids=["cdct-route", "none", "perceptual", "torch",
                              "cdct-qss24"])
def test_batch_codec_on_cuda_matches_cpu(dev, kw):
    frames = np.stack([make_test_image(61, 90, seed=i) for i in range(3)])
    cfg = CodecConfig(**kw)
    gpu, cpu = BatchCodec(cfg, dev), BatchCodec(cfg, "cpu")
    counters = (dk.fused_cdct_quantize, dk.fused_dequantize_cdct,
                dk.fused_dct_quantize, dk.fused_dequantize_idct)
    before = sum(f.launches for f in counters)
    planes = gpu.encode_planes(frames)
    _index_rule(torch.from_numpy(planes), torch.from_numpy(
        cpu.encode_planes(frames)))
    rec = gpu.decode_planes(planes, original_hw=(61, 90))
    assert rec.shape == frames.shape
    _pixel_rule(rec, cpu.decode_planes(planes, original_hw=(61, 90)))
    launched = sum(f.launches for f in counters) - before
    assert launched == (0 if gpu.route == "torch" else 2)


@pytest.mark.parametrize("entropy_name", ["grans", "tiff"])
def test_iii_on_cuda_matches_cpu(dev, entropy_name):
    frames = make_test_video(4, 96, 112)
    vcfg, ccfg = VideoConfig(n_frames=4), CodecConfig(entropy=entropy_name)
    gpu, cpu = video.get(vcfg, ccfg, dev), video.get(vcfg, ccfg, "cpu")
    planes_g = gpu._batch.encode_planes(frames)
    planes_c = cpu._batch.encode_planes(frames)
    _index_rule(torch.from_numpy(planes_g), torch.from_numpy(planes_c))
    cs_g, cs_c = gpu.encode(frames), cpu.encode(frames)
    if np.array_equal(planes_g, planes_c):
        assert cs_g.to_bytes() == cs_c.to_bytes()
    rec_g = gpu.decode(CodeStream.from_bytes(cs_g.to_bytes()))
    assert rec_g.shape == frames.shape
    _pixel_rule(rec_g, cpu.decode(cs_g))
    assert abs(metrics.rmse(frames, rec_g)
               - metrics.rmse(frames, cpu.decode(cs_c))) < 1e-3


# (G, H, W, m, s): every block-size instance (4, 8, 16, 32) and the
# generic mode (m = 6, 5: no instance), ranges 0..8, G > 1 and G = 1,
# non-square frames, odd block counts (7 x 3 blocks at m = 16; a row that
# leaves the last CTA ragged), rows wide enough for CTAs of many blocks
# (15 at m = 16, s = 8: the ties below sum a thread an item)
SAD_CASES = [(3, 48, 80, 8, 4), (2, 64, 96, 16, 8), (1, 32, 160, 16, 4),
             (4, 56, 48, 8, 8), (2, 48, 112, 16, 8), (1, 48, 112, 16, 8),
             (2, 24, 44, 4, 3), (2, 64, 96, 32, 8), (1, 96, 160, 32, 2),
             (2, 48, 72, 6, 3), (1, 45, 60, 5, 2), (2, 32, 48, 16, 0),
             (1, 32, 80, 16, 1), (1, 64, 240, 16, 8), (1, 48, 160, 8, 8)]


def _sad_equal(ref, cur, m, s):
    """The kernel's mvs and SADs equal the plain version's; one launch,
    counted as generic exactly when m has no instance or (m, s) is past
    the instance's shared memory (the generic kernel's global mode)."""
    before = sk.sad_search.launches
    generic = sk.sad_search.generic_launches
    mv, sad = sk.sad_search(ref, cur, m, s)
    mv_p, sad_p = sk.sad_search_ref(ref, cur, m, s)
    assert torch.equal(mv, mv_p) and torch.equal(sad, sad_p)
    assert sk.sad_search.launches == before + 1
    assert sk.sad_search.generic_launches == generic + int(
        m not in sk.INSTANCES or _build.load().vcf_sad_smem(m, s) < 0)
    return mv, sad


@pytest.mark.parametrize("g,h,w,m,s", SAD_CASES)
def test_sad_kernel_matches_plain_version(dev, g, h, w, m, s):
    frames = make_test_video(g + 1, h, w, seed=g + h)
    luma = motion.to_luma(torch.from_numpy(frames).to(dev))
    ref, cur = luma[:-1].contiguous(), luma[1:].contiguous()
    _sad_equal(ref, cur, m, s)
    # ties (a flat frame pair): the first minimum in row-major order wins
    rng = np.random.default_rng(h)
    flat = torch.from_numpy(rng.integers(0, 3, (2, g, h, w)).astype(
        np.float32)).to(dev)
    _sad_equal(flat[0], flat[1], m, s)
    # one frame without the GOP axis
    mv1, _ = _sad_equal(ref[0], cur[0], m, s)
    assert torch.equal(mv1, sk.sad_search(ref, cur, m, s)[0][0])
    torch.cuda.synchronize()


@pytest.mark.parametrize("g,h,w,m,s", SAD_CASES)
def test_sad_kernel_ties_and_near_ties(dev, g, h, w, m, s):
    """Every displacement tying at a nonzero SAD (a constant frame under a
    brightness change: every screened sum is a candidate), the same with
    the reference's lumas raised by 0 or 2^-14 at random (every
    displacement a candidate, the exact minimum anywhere in a run), and
    crafted near ties (rows constant along x plus 2^-14 steps, the current
    frame the next row + 50: every dx of dy = 1 within the screen's bound
    of each other, the exact sums apart by multiples of 2^-14)."""
    flat = torch.full((g, h, w), 37.114, dtype=torch.float32, device=dev)
    mv, sad = _sad_equal(flat, flat + 3.25, m, s)
    assert bool((mv == -s).all()) and bool((sad == 3.25 * m * m).all())
    rng = np.random.default_rng(w + s)
    noisy = 37.0 + rng.integers(0, 2, (g, h, w)).astype(np.float32) * 2.0 ** -14
    _sad_equal(torch.from_numpy(noisy).to(dev), flat + 3.136, m, s)
    rows = rng.integers(0, 200, (g, h + 1, 1)).astype(np.float32)
    steps = rng.integers(0, 2, (g, h + 1, w)).astype(np.float32) * 2.0 ** -14
    ref = torch.from_numpy(rows[:, :h] + steps[:, :h]).to(dev)
    cur = torch.from_numpy(np.broadcast_to(rows[:, 1:] + 50.0, (g, h, w))
                           .copy()).to(dev)
    _sad_equal(ref, cur, m, s)
    torch.cuda.synchronize()


def test_sad_kernel_takes_every_range_accepted_before(dev):
    """Shared memory: the staged modes' gate (`vcf_sad_smem`) takes every
    (m, s) the first design took (its window and block in 48 KiB of
    float64), exactly those in the generic mode and larger ranges at the
    instances; past it the generic kernel's global mode takes the shape,
    so the card takes every range (`vcf_sad_mode`, `fits`); each
    instance's largest staged range and the first ranges past the gates
    run bit-exact against the plain version."""
    lib = _build.load()
    largest = {}
    for m in (1, 3, 4, 5, 8, 12, 16, 32):
        for s in range(0, 81):
            first = ((m + 2 * s) ** 2 + m * m) * 8 <= sk.FIRST_DESIGN_SMEM
            takes = lib.vcf_sad_smem(m, s) >= 0
            assert takes >= first
            if m not in sk.INSTANCES:
                assert takes == first
            if takes:
                largest[m] = s
            assert sk.fits(m, s, dev)
            assert lib.vcf_sad_mode(m, s) == (
                2 if not takes else 0 if m in sk.INSTANCES else 1)
    for m in sk.INSTANCES:
        assert largest[m] > max(s for s in range(61) if (
            (m + 2 * s) ** 2 + m * m) * 8 <= sk.FIRST_DESIGN_SMEM)
    assert largest[16] == 76
    assert lib.vcf_sad_mode(0, 4) == lib.vcf_sad_mode(16, -1) == -1
    rng = np.random.default_rng(3)
    past = [(m, largest[m] + 1) for m in (4, 16, 12)]
    for m, s in ([(m, largest[m]) for m in sk.INSTANCES] + [(6, 20)]
                 + past):
        lumas = torch.from_numpy(rng.integers(0, 256, (2, 1, 2 * m, 3 * m))
                                 .astype(np.float32)).to(dev)
        _sad_equal(lumas[0], lumas[1], m, s)
    torch.cuda.synchronize()


def test_sad_count_refined(dev):
    """count_refined: the kernel's outputs, and the screen's second sums
    (none where every minimum is 0 or alone; every displacement where all
    tie)."""
    g, h, w, m, s = 2, 48, 112, 16, 8
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (g, h, w)).astype(np.float32)).to(dev)
    mv, sad, n, by_thread = sk.count_refined(x, x, m, s)
    assert n == 0 and by_thread == 0
    assert bool((mv == 0).all()) and bool((sad == 0).all())
    flat = torch.full((g, h, w), 9.0, dtype=torch.float32, device=dev)
    _, _, n, _ = sk.count_refined(flat, flat + 1.0, m, s)
    assert n == g * (h // m) * (w // m) * (2 * s + 1) ** 2


@pytest.mark.parametrize("w,by_thread", [(32, False), (240, True)])
def test_sad_refinement_modes(dev, w, by_thread):
    """A CTA sums its listed candidates a warp an item when the list is
    short (2 blocks a row: at most 34 items a CTA) and a thread an item
    when it is long (15 blocks, 255 items, all listed), bit-exact either
    way, on ties whose exact minimum lies anywhere in a run."""
    g, h, m, s = 1, 64, 16, 8
    rng = np.random.default_rng(w)
    ref = torch.from_numpy(37.0 + rng.integers(0, 2, (g, h, w)).astype(
        np.float32) * 2.0 ** -14).to(dev)
    cur = torch.full((g, h, w), 40.25, dtype=torch.float32, device=dev)
    mv, sad, n, n_thread = sk.count_refined(ref, cur, m, s)
    mv_p, sad_p = sk.sad_search_ref(ref, cur, m, s)
    assert torch.equal(mv, mv_p) and torch.equal(sad, sad_p)
    assert n > 0 and (n_thread > 0) == by_thread


@pytest.mark.parametrize("g,h,w,m,s", SAD_CASES)
def test_mc_kernel_matches_plain_version(dev, g, h, w, m, s):
    rng = np.random.default_rng(w)
    ref = torch.from_numpy(rng.integers(0, 256, (g, 3, h, w)).astype(
        np.float32)).to(dev)
    mv_np = rng.integers(-s, s + 1, (g, h // m, w // m, 2)).astype(np.int32)
    mv_np[:, 0, :, 0], mv_np[:, :, -1, 1] = -s, s          # out of the frame
    mv = torch.from_numpy(mv_np).to(dev)
    out = mk.mc_apply_planar(ref, mv, m)
    assert torch.equal(out, mk.mc_apply_planar_ref(ref, mv, m))
    cl = ref.permute(0, 2, 3, 1).contiguous()
    out_cl = mk.mc_apply(cl, mv, m)
    assert torch.equal(out_cl, mk.mc_apply_ref(cl, mv, m))
    assert torch.equal(out_cl, out.permute(0, 2, 3, 1))
    assert torch.equal(mk.mc_apply_planar(ref[0], mv[0], m), out[0])
    torch.cuda.synchronize()


# (g, c, h, w, m, storage offset in floats, mv range, 3-D): every route of
# the MC kernel's choice: m = 4, 8, 16, 32 (vector mode), m = 5, 6 and
# W * C % 4 != 0 (generic), C = 1 and 3, a storage offset of 1 float
# (generic by alignment) or 4 (aligned), mvs past the frame by more than
# its size, 3-D and 4-D frames
MC_MODE_CASES = [
    (2, 3, 32, 48, 4, 0, 3, False), (2, 3, 48, 64, 8, 0, 9, False),
    (2, 3, 64, 1920, 16, 0, 8, False), (1, 3, 64, 96, 32, 0, 40, False),
    (2, 1, 32, 48, 16, 0, 8, False), (1, 3, 32, 48, 16, 0, 8, True),
    (2, 3, 30, 35, 5, 0, 4, False), (1, 1, 36, 48, 6, 0, 7, False),
    (2, 3, 32, 48, 16, 1, 8, False), (2, 3, 32, 48, 16, 4, 8, False),
    (2, 3, 32, 64, 16, 0, 200, False), (1, 1, 24, 40, 8, 1, 50, True),
]


@pytest.mark.parametrize("g,c,h,w,m,offset,far,three_d", MC_MODE_CASES)
def test_mc_kernel_modes(dev, g, c, h, w, m, offset, far, three_d):
    """Both layouts equal the plain versions bit for bit; the launch takes
    the mode of `launch_mode`, which equals the C launcher's
    `vcf_mc_mode`."""
    rng = np.random.default_rng(h * w + m)
    n = g * c * h * w
    mv = torch.from_numpy(rng.integers(-far, far + 1, (g, h // m, w // m, 2))
                          .astype(np.int32)).to(dev)
    lib = _build.load()
    for cl, fn, plain in ((False, mk.mc_apply_planar, mk.mc_apply_planar_ref),
                          (True, mk.mc_apply, mk.mc_apply_ref)):
        flat = torch.from_numpy(rng.integers(0, 256, n + offset).astype(
            np.float32)).to(dev)
        shape = (g, h, w, c) if cl else (g, c, h, w)
        ref = flat[offset:].view(shape)
        mvs = mv
        if three_d:
            ref, mvs = ref[0], mv[0]
        fn.launches = fn.generic_launches = 0
        out = fn(ref, mvs, m)
        assert torch.equal(out, plain(ref, mvs, m))
        mode = mk.launch_mode(m, ref.data_ptr(), out.data_ptr())
        want = "vector" if m % 4 == 0 and offset % 4 == 0 else "generic"
        assert mode == want
        assert lib.vcf_mc_mode(ref.data_ptr(), out.data_ptr(), c, w,
                               m) == (mode == "generic")
        assert (fn.launches, fn.generic_launches) == (1, int(mode == "generic"))
    torch.cuda.synchronize()


def _rows_grid(l, s, density, seed):
    rng = np.random.default_rng(seed)
    low = rng.integers(0, 1 << 16, (l, s))
    flag = rng.random((l, s)) < density
    return torch.from_numpy((low | flag.astype(np.int64) << 16).astype(
        np.int32))


# (L, S, share of entries flagged, rows sliced off a grid with one more):
# S % 4 != 0, S below one round (4096 entries), L = 1, a raw base 4 bytes
# off 16-byte alignment (a row slice of a grid with S = 4097), every entry
# flagged and none, and the main path's S with a ragged last round
ROWS_CASES = [(5, 1101, 0.2, False), (7, 100, 0.4, False),
              (1, 5000, 0.1, False), (3, 4097, 0.1, True),
              (2, 8192, 1.0, False), (2, 8192, 0.0, False),
              (4, 65536, 0.014, False), (3, 12292, 0.3, False)]


@pytest.mark.parametrize("l,s,density,sliced", ROWS_CASES)
def test_row_mode_matches_plain_version(dev, l, s, density, sliced):
    raw = _rows_grid(l + sliced, s, density, l * s).to(dev)
    if sliced:
        raw = raw[1:]
        assert raw.is_contiguous() and raw.data_ptr() % 16 == 4
    rows, counts = re_.rans_compact_rows(raw)
    rows_p, counts_p = re_.rans_compact_rows_ref(raw)
    assert torch.equal(counts, counts_p)
    prefix = torch.arange(s, device=dev) < counts[:, None]
    assert torch.equal(rows.masked_fill(~prefix, 0), rows_p)


@pytest.mark.parametrize("kw", [dict(entropy="grans"),
                                dict(entropy="zlib", use_pallas=False),
                                dict(entropy="zlib", qss=16)],
                         ids=["grans", "torch-route", "zlib"])
def test_ipp_on_cuda_matches_cpu(dev, kw):
    frames = make_test_video(6, 96, 112)
    vcfg = VideoConfig(mode="ipp", n_frames=6, gop_size=4, rdo_lambda=0.5)
    ccfg = CodecConfig(**kw)
    gpu, cpu = video.get(vcfg, ccfg, dev), video.get(vcfg, ccfg, "cpu")
    cs_g, cs_c = gpu.encode(frames), cpu.encode(frames)
    # a ±1 index on a rounding edge moves the P chain after it: mvs and
    # modes may then differ on a few blocks, the rmse by < 1e-2
    names = [name for name in cs_c if name.startswith(("mv_", "modes_"))]
    n_diff = sum(int(np.count_nonzero(cs_g.get_array(k) != cs_c.get_array(k)))
                 for k in names)
    assert n_diff <= 0.01 * sum(cs_c.get_array(k).size for k in names)
    d = np.abs(gpu.last_planes.astype(np.int64) - cpu.last_planes)
    assert d.max() <= 1 and np.count_nonzero(d) <= 5e-4 * d.size
    if not d.any() and not n_diff:
        assert cs_g.to_bytes() == cs_c.to_bytes()
    rec_g = gpu.decode(CodeStream.from_bytes(cs_g.to_bytes()))
    np.testing.assert_array_equal(rec_g.astype(np.float32),
                                  gpu.last_recon.cpu().numpy())
    rmse = metrics.rmse(frames, rec_g)
    assert abs(rmse - metrics.rmse(frames, cpu.decode(cs_g))) <= 1e-2
    assert abs(rmse - metrics.rmse(frames, cpu.decode(cs_c))) <= 1e-2


def test_ipp_search_range_past_the_kernel_gate(dev):
    """ROADMAP C12 on the card: at m = 16 the first range past the
    instance's shared memory (s = 77) still takes the kernel (its generic
    global mode), while the CPU run takes the full search by shape; the
    two encode alike (both searches are exact)."""
    m = 16
    s = next(s for s in range(1, 1000)
             if _build.load().vcf_sad_smem(m, s) < 0)
    assert not sk.fits(m, s, "cpu")
    frames = np.random.default_rng(s).integers(0, 256, (2, 32, 48, 3),
                                               dtype=np.uint8)
    vcfg = VideoConfig(mode="ipp", n_frames=2, gop_size=2, search_range=s)
    gpu, cpu = video.get(vcfg, CodecConfig(), dev), video.get(
        vcfg, CodecConfig(), "cpu")
    assert gpu._make_search(32, 48).kind == "sad_search"
    assert cpu._make_search(32, 48).kind == "full_search"
    before = sk.sad_search.launches
    generic = sk.sad_search.generic_launches
    cs_g, cs_c = gpu.encode(frames), cpu.encode(frames)
    assert sk.sad_search.launches > before
    assert sk.sad_search.generic_launches - generic == (
        sk.sad_search.launches - before)
    np.testing.assert_array_equal(cs_g.get_array("mv_0001"),
                                  cs_c.get_array("mv_0001"))
    d = np.abs(gpu.last_planes.astype(np.int64) - cpu.last_planes)
    assert d.max() <= 1 and np.count_nonzero(d) <= 5e-4 * d.size
    if not d.any():
        assert cs_g.to_bytes() == cs_c.to_bytes()
    rec_g = gpu.decode(CodeStream.from_bytes(cs_g.to_bytes()))
    np.testing.assert_array_equal(rec_g.astype(np.float32),
                                  gpu.last_recon.cpu().numpy())


def _ctx_case(g, sg, l, n_ctx, seed):
    rng = np.random.default_rng(seed)
    noise = rng.integers(-9, 10, size=(g * sg, l)) * (
        rng.random((g * sg, l)) < 0.5)
    syms = np.clip(128 + np.cumsum(noise, axis=1) // 2, 0, 255).astype(np.uint8)
    counts = rans.ctx_group_histograms(torch.from_numpy(syms), g, n_ctx)
    return syms, *rans.ctx_freqs_from_counts(counts.numpy())


# (G, sg, L, n_ctx): 4 and 15 classes; sg = 2 spans many groups per
# encode and decode block (the global-table paths); G = 64 with 15
# classes at sg = 128, whose decode rows the one-block kernel reads from
# global memory and the look-back kernel's blocks hold in shared memory;
# a ragged S = 1100
CTX_CASES = [(4, 8, 12, 4), (64, 2, 10, 4), (64, 4, 24, 15), (17, 16, 8, 15),
             (2, 128, 8, 4), (1, 1100, 5, 4), (64, 128, 6, 15)]


@pytest.mark.parametrize("g,sg,l,n_ctx", CTX_CASES)
def test_ctx_kernels_match_plain_versions(dev, g, sg, l, n_ctx):
    syms, fg, cg = _ctx_case(g, sg, l, n_ctx, seed=g + l)
    s = torch.from_numpy(syms).to(dev)
    ft = torch.from_numpy(fg.astype(np.int64)).to(dev)
    ct = torch.from_numpy(cg.astype(np.int64)).to(dev)
    before = (rc.rans_encode_ctx.launches, rc.rans_decode_ctx.launches)
    raw, st = rc.rans_encode_ctx(s, ft, ct)
    raw_p, st_p = rc.rans_encode_ctx_ref(s, ft, ct)
    assert torch.equal(raw, raw_p) and torch.equal(st, st_p)
    words, n_words, counts = re_.rans_compact(raw)
    words = words[:int(n_words)].clone()
    out = rc.rans_decode_ctx(words, st, ft, ct, l, counts)
    assert torch.equal(out, rc.rans_decode_ctx_ref(words, st, ft, ct, l,
                                                   counts))
    assert torch.equal(out, s)
    assert torch.equal(rc.rans_decode_ctx(words, st, ft, ct, l), s)
    assert (rc.rans_encode_ctx.launches, rc.rans_decode_ctx.launches) == (
        before[0] + 1, before[1] + 2)
    # with counts a 128-lane block holds the rows of the groups it spans,
    # in at most 48 KiB; without, the one-block kernel all G groups' rows
    span = min(g, -(-128 // sg) + 1)
    want = "global" if span * n_ctx * 257 * 2 > 48 * 1024 else "shared"
    assert rc.decode_table_mode(g * sg, g, n_ctx) == want
    want = "global" if g * n_ctx * 257 * 2 > 200 * 1024 else "shared"
    assert rc.decode_table_mode(g * sg, g, n_ctx, counts=False) == want


@pytest.mark.parametrize("n_ctx", [4, 15])
def test_ctx_decode_rejects_corrupt_stream(dev, n_ctx):
    syms, fg, cg = _ctx_case(4, 32, 16, n_ctx, seed=5)
    ft = torch.from_numpy(fg.astype(np.int64)).to(dev)
    ct = torch.from_numpy(cg.astype(np.int64)).to(dev)
    raw, st = rc.rans_encode_ctx(torch.from_numpy(syms).to(dev), ft, ct)
    words, n_words, counts = re_.rans_compact(raw)
    words = words[:int(n_words)].clone()
    assert words.numel() > 0
    bad = counts.clone()
    bad[0] += 1
    with pytest.raises(ValueError, match="counts sidecar"):
        rc.rans_decode_ctx(words, st, ft, ct, 16, bad)
    with pytest.raises(ValueError, match="ends before"):
        rc.rans_decode_ctx(words[:-1].clone(), st, ft, ct, 16)
    with pytest.raises(ValueError, match="left over"):
        rc.rans_decode_ctx(torch.cat([words, words[:1]]), st, ft, ct, 16)


@pytest.mark.parametrize("n_ctx", [4, 15])
def test_cgrans_on_cuda_matches_cpu(dev, n_ctx):
    rng = np.random.default_rng(n_ctx)
    runs = np.repeat((128 + rng.normal(0, 6, size=(3, 512))).clip(0, 255),
                     64, axis=1)[:, :24576]
    planes = runs.reshape(3, 128, 192).transpose(1, 2, 0)[None].astype(
        np.uint8)
    gpu = entropy.get("cgrans", CodecConfig(context_classes=n_ctx), device=dev)
    cpu = entropy.get("cgrans", CodecConfig(context_classes=n_ctx),
                      device="cpu")
    gpu.MIN_SYMBOLS = cpu.MIN_SYMBOLS = 0
    payload, side = gpu.encode(planes)
    assert side["cgrans_model"][:2] == bytes([2, n_ctx])
    assert (payload, side) == cpu.encode(planes)
    assert np.array_equal(gpu.decode(payload, side), planes)


@pytest.mark.parametrize("kw", [dict(entropy="grans"),
                                dict(entropy="cgrans", context_classes=15),
                                dict(entropy="zlib", wavelet="bior4.4")],
                         ids=["grans", "cgrans15", "zlib-bior4.4"])
def test_dwt_on_cuda_matches_cpu(dev, monkeypatch, kw):
    monkeypatch.setattr(dwt_ops, "CTX_MIN_SYMBOLS", 0)
    img = make_test_image(96, 128, seed=4)
    cfg = CodecConfig(spatial="dwt", qss=16, dwt_levels=3, **kw)
    gpu, cpu = Codec(cfg, device=dev), Codec(cfg, device="cpu")
    for a, b in zip(gpu._dwt._analysis(gpu, img), cpu._dwt._analysis(cpu, img)):
        assert torch.equal(a.cpu(), b)
    cs = gpu.encode(img)
    assert cs.to_bytes() == cpu.encode(img).to_bytes()
    rec = gpu.decode(CodeStream.from_bytes(cs.to_bytes()))
    assert np.array_equal(rec, cpu.decode(cs))


def test_dwt_clip_path_on_cuda_matches_cpu(dev):
    """The DWT clip entries on the card: a 3-frame clip's lanes, its
    context stream (K1's context mode, K2, K3's look-back) and its frames
    equal the CPU's bit for bit; K1's (L, S) copy of the grid adds its
    bytes read and written to `layout_bytes`."""
    from vcf_tpu_torch.entropy import dwt_device as dd
    from vcf_tpu_torch.utils import profiling

    cfg = CodecConfig(spatial="dwt", entropy="cgrans")
    gpu, cpu = Codec(cfg, device=dev), Codec(cfg, device="cpu")
    clip = np.stack([make_test_image(96, 128, seed=s) for s in (5, 6, 7)])
    shape = clip.shape[1:]
    lanes = gpu._dwt.clip_to_lanes(gpu, torch.from_numpy(clip).to(dev))
    lanes_c = cpu._dwt.clip_to_lanes(cpu, torch.from_numpy(clip))
    assert torch.equal(lanes.cpu(), lanes_c)
    g = len(cpu._dwt._grid_sizes(shape))
    fg, cg = (torch.from_numpy(t.astype(np.int64))
              for t in dd.train_ctx_tables(lanes_c, g, 4))
    before = profiling.counts()["layout_bytes"]
    words, n_words, counts, states = rans.encode_lanes_device(
        lanes, fg.to(dev), cg.to(dev))
    assert profiling.counts()["layout_bytes"] - before == 2 * lanes.numel()
    words_c, n_words_c, counts_c, states_c = rans.encode_lanes_device(
        lanes_c, fg, cg)
    n = int(n_words)
    assert n == int(n_words_c)
    assert torch.equal(words[:n].cpu(), words_c[:n])
    assert torch.equal(counts.cpu(), counts_c)
    assert torch.equal(states.cpu(), states_c)
    out = rc.rans_decode_ctx(words[:n], states, fg.to(dev), cg.to(dev),
                             lanes.shape[1], counts)
    assert torch.equal(out.cpu(), lanes_c)
    frames = gpu._dwt.lanes_to_clip(gpu, out, shape)
    assert torch.equal(frames.cpu(),
                       cpu._dwt.lanes_to_clip(cpu, lanes_c, shape))


@pytest.mark.parametrize("qss", [24, 32, 7])
def test_deadzone_quantize_on_cuda_is_ieee(dev, qss):
    """trunc(x / qss) with the IEEE quotient on the card, as on the CPU
    (PyTorch divides by a Python scalar on CUDA through its reciprocal)."""
    from vcf_tpu_torch.ops import quantize as q_ops

    rng = np.random.default_rng(qss)
    x = torch.from_numpy((rng.normal(0, 300, 1 << 20)).astype(np.float32))
    # values on and next to multiples of qss, where a rounded quotient
    # crosses an integer
    k = torch.from_numpy(rng.integers(-60, 60, 1 << 16).astype(np.float32))
    x = torch.cat([x, k * qss, torch.nextafter(k * qss, k * qss - 1)])
    assert torch.equal(q_ops.deadzone_quantize(x.to(dev), qss).cpu(),
                       q_ops.deadzone_quantize(x, qss))


# ---------------------------------------------------------------------------
# The lane-grid path: grid modes of B1-B4, K1 L-major, the row mode of K2,
# the routing-free grid decodes, IPPCodec's planar grid loop
# ---------------------------------------------------------------------------

# (N, H, W, b, qss, off): cw = 256, 512 (W = 2048), 128, 96 (a chunk
# narrower than a b = 8 strip), 256, 192 (three b = 16 strips a chunk),
# 256 and 128: every block size of both kernels' grid modes; W = 40 and
# 72 (W % 16 != 0; chunks of 40 and 72, narrower than a strip); inputs
# whose storage starts one element into their buffer
GRID_DCT_CASES = [(2, 64, 256, 8, 32, 0), (1, 32, 2048, 8, 32, 0),
                  (2, 64, 128, 4, 24, 0), (1, 32, 96, 8, 24, 0),
                  (1, 32, 256, 2, 32, 0), (2, 64, 192, 16, 24, 0),
                  (1, 64, 256, 32, 32, 0), (1, 32, 128, 1, 32, 0),
                  (2, 32, 40, 8, 32, 0), (1, 64, 72, 4, 24, 0),
                  (2, 32, 1920, 8, 32, 1)]


@pytest.mark.parametrize("n,h,w,b,qss,off", GRID_DCT_CASES)
def test_dct_grid_modes_are_block_modes_permuted(dev, n, h, w, b, qss, off):
    """The grid mode permutes the block mode's stores and loads: equal to
    the block-mode kernel's output permuted, bit for bit, and within the
    +-1 rule of the plain version."""
    rng = np.random.default_rng(h + w + b)
    px = _at_offset(torch.from_numpy(rng.integers(0, 256, (n, 3, h, w),
                                                  np.uint8)).to(dev), off)
    planes = _at_offset(torch.from_numpy(rng.normal(0, 80, (n, 3, h, w))
                                         .astype(np.float32)).to(dev), off)
    mf = dk.static_mat(color_ops.YCOCG_FWD)
    mi = dk.static_mat(color_ops.YCOCG_INV)
    kw = dict(b=b, qss=qss)
    k3 = dk.fused_cdct_quantize(px, mf, grid_layout=True, **kw)
    assert torch.equal(k3, dk.to_grid(dk.fused_cdct_quantize(px, mf, **kw), b))
    d = (k3.cpu().to(torch.int64) - dk.fused_cdct_quantize_ref(
        px, mf, grid_layout=True, **kw).cpu()).abs()
    assert d.max() <= 1 and (d != 0).sum() <= 1e-4 * d.numel()
    p4 = dk.fused_dequantize_cdct(k3, mi, grid_layout=True, **kw)
    assert torch.equal(p4, dk.fused_dequantize_cdct(dk.from_grid(k3, b), mi,
                                                    **kw))
    for perc in (False, True):
        k1 = dk.fused_dct_quantize(planes, perceptual=perc, grid_layout=True,
                                   **kw)
        assert torch.equal(k1, dk.to_grid(dk.fused_dct_quantize(
            planes, perceptual=perc, **kw), b))
        x2 = dk.fused_dequantize_idct(k1, perceptual=perc, grid_layout=True,
                                      **kw)
        assert torch.equal(x2, dk.fused_dequantize_idct(
            dk.from_grid(k1, b), perceptual=perc, **kw))
        x2p = dk.fused_dequantize_idct_ref(k1, perceptual=perc,
                                           grid_layout=True, **kw)
        assert float((x2 - x2p).abs().max()) <= 1e-3


@pytest.mark.parametrize("g,sg,l", CASES)
def test_lane_grid_rans_modes_match_plain_versions(dev, g, sg, l):
    syms, fg, cg = _case(g, sg, l, seed=g * l)
    s = torch.from_numpy(syms).to(dev)
    s_l = s.t().contiguous()
    ft = torch.from_numpy(fg.astype(np.int64)).to(dev)
    ct = torch.from_numpy(cg.astype(np.int64)).to(dev)
    raw, st = re_.rans_encode_grouped(s_l.t(), ft, ct)
    raw_t, st_t = re_.rans_encode_grouped(s, ft, ct)
    assert torch.equal(raw, raw_t) and torch.equal(st, st_t)
    rows, counts, st_r = re_.rans_encode_rows(s_l.t(), ft, ct)
    rows_p, counts_p = re_.rans_compact_rows_ref(raw)
    assert torch.equal(counts, counts_p)
    # only each row's prefix is defined; the plain version zeroes the tail
    prefix = torch.arange(rows.shape[1], device=dev) < counts[:, None]
    assert torch.equal(rows.masked_fill(~prefix, 0), rows_p)
    assert torch.equal(st_r, st)
    words, n_words = re_.assemble_stream(rows, counts)
    w2, n2, c2 = re_.rans_compact(raw)
    n = int(n_words)
    assert n == int(n2) and torch.equal(words[:n], w2[:n])
    assert torch.equal(counts, c2)
    out = rd.rans_decode_grouped_grid(raw, st, ft, ct, l)
    assert torch.equal(out, s) and torch.equal(out.t(), s_l)
    assert out.t().is_contiguous()
    assert torch.equal(rd.rans_decode_grouped(
        words[:n].clone(), st, ft, ct, l, counts), out)
    assert torch.equal(rd.rans_decode_grouped_grid_ref(raw, st, ft, ct, l),
                       s_l)


def test_grid_decode_rejects_a_bad_grid(dev):
    syms, fg, cg = _case(4, 64, 8, seed=5)
    ft = torch.from_numpy(fg.astype(np.int64)).to(dev)
    ct = torch.from_numpy(cg.astype(np.int64)).to(dev)
    raw, st = re_.rans_encode_grouped(torch.from_numpy(syms).to(dev), ft, ct)
    t, s = (raw >> 16).nonzero()[0].tolist()
    raw[t, s] &= 0xFFFF
    with pytest.raises(ValueError, match="emit flags"):
        rd.rans_decode_grouped_grid(raw, st, ft, ct, 8)


@pytest.mark.parametrize("g,sg,l,n_ctx", CTX_CASES)
def test_ctx_grid_decode_matches_plain_version(dev, g, sg, l, n_ctx):
    rng = np.random.default_rng(g + n_ctx)
    syms = (128 + rng.normal(0, 20, (g * sg, l))).clip(0, 255).astype(np.uint8)
    s = torch.from_numpy(syms).to(dev)
    fg, cg = rans.ctx_freqs_from_counts(
        rans.ctx_group_histograms(s, g, n_ctx).cpu().numpy())
    ft = torch.from_numpy(fg.astype(np.int64)).to(dev)
    ct = torch.from_numpy(cg.astype(np.int64)).to(dev)
    raw, st = rc.rans_encode_ctx(s, ft, ct)
    out = rc.rans_decode_ctx_grid(raw, st, ft, ct, l)
    assert torch.equal(out, s)
    assert torch.equal(rc.rans_decode_ctx_grid_ref(raw, st, ft, ct, l), s.t())


def test_ipp_planar_grid_loop_on_cuda_matches_cpu(dev):
    frames = make_test_video(4, 64, 128, seed=9)
    vcfg = VideoConfig(mode="ipp", n_frames=4, gop_size=4, search_range=4)
    ccfg = CodecConfig(entropy="grans")
    gpu, cpu = video.get(vcfg, ccfg, dev), video.get(vcfg, ccfg, "cpu")
    gops = torch.from_numpy(frames)[None]
    planes, mvs = gpu._gop_encode_grid_batch(gops.to(dev))
    planes_c, mvs_c = cpu._gop_encode_grid_batch(gops)
    assert torch.equal(mvs.cpu(), mvs_c)
    d = (planes.cpu().to(torch.int64) - planes_c).abs()
    assert d.max() <= 1 and (d != 0).sum() <= 5e-4 * d.numel()
    rec = gpu._gop_decode_grid_batch(planes, mvs)
    assert torch.equal(rec, gpu.last_grid_recon)
    assert torch.equal(rec.cpu(), cpu._gop_decode_grid_batch(planes.cpu(),
                                                             mvs.cpu()))


# The grid decode's paths (csrc/rans_grid.cu), chosen by shape: L around
# its staged tile of GT steps (1, GT - 1, GT, GT + 1); S that picks 32,
# 64 and 128 lanes a block on a 132-SM card (1100, 8704, 16896); a
# ragged S (1099: plain loads); sg = 2 under 128-lane blocks (tables in
# global memory); tables with zero-frequency symbols between used ones,
# and one symbol at frequency 2^15.
GT = rd.GRID_TILE
GRID_CASES = [(1, 1100, 1, "random"), (1, 1100, GT - 1, "zeros"),
              (1, 1100, GT, "random"), (1, 1100, GT + 1, "single"),
              (17, 512, GT + 1, "random"), (64, 264, GT - 1, "zeros"),
              (1, 1099, GT + 1, "random"), (8448, 2, GT + 1, "zeros")]


def _grid_tables(kind, g, rng):
    """(G, 256) freqs and cums: every symbol used ("random"), most
    symbols at frequency 0 ("zeros"), one symbol at 2^15 ("single")."""
    if kind == "single":
        f = np.zeros((g, 256), np.int64)
        f[:, 77] = 1 << 15
    else:
        counts = rng.integers(1, 1000, (g, 256))
        if kind == "zeros":
            counts *= rng.random((g, 256)) < 0.2
            counts[:, [0, 1, 255]] = 0
            counts[:, 17] += 5
        f = np.stack([rans.quantize_freqs(c, min_all=kind == "random")
                      for c in counts]).astype(np.int64)
    c = np.concatenate([np.zeros((g, 1), np.int64), np.cumsum(f, 1)[:, :255]],
                       axis=1)
    return f, c


def _symbols_of(f, sg, l, rng):
    """(G * sg, L) symbols drawn from each group's freqs."""
    return np.concatenate([rng.choice(256, size=(sg, l), p=fi / fi.sum())
                           for fi in f]).astype(np.uint8)


def _grid_plan_on(dev, s_streams, g, n_ctx):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = rd.decode_plan(s_streams, g, n_ctx)
    assert plan == rd.decode_plan_for(s_streams, g, n_ctx, sms)
    return plan


@pytest.mark.parametrize("g,sg,l,kind", GRID_CASES)
def test_grid_decode_paths_match_plain_version(dev, g, sg, l, kind):
    """Order 0 on every path of the kernel, through the wrapper and on a
    grid 4 bytes off 16-byte alignment (plain loads), against the plain
    version and the encoded symbols."""
    rng = np.random.default_rng(g + sg + l)
    f, c = _grid_tables(kind, g, rng)
    s = torch.from_numpy(_symbols_of(f, sg, l, rng)).to(dev)
    ft, ct = _tables(dev, f, c)
    raw, st = re_.rans_encode_grouped(s, ft, ct)
    before = rd.rans_decode_grouped_grid.launches
    out = rd.rans_decode_grouped_grid(raw, st, ft, ct, l)
    assert rd.rans_decode_grouped_grid.launches == before + 1
    assert torch.equal(out, s)
    assert torch.equal(rd.rans_decode_grouped_grid_ref(raw, st, ft, ct, l),
                       s.t())
    buf = torch.empty(raw.numel() + 1, dtype=torch.int32, device=dev)
    off = buf[1:].view(raw.shape)
    off.copy_(raw)
    assert torch.equal(rd.rans_decode_grouped_grid(off, st, ft, ct, l), s)
    plan = _grid_plan_on(dev, g * sg, g, 0)
    lanes = {1100: 32, 1099: 32, 8704: 64, 16896: 128}[g * sg]
    assert plan["lanes"] == lanes
    assert plan["tables"] == ("global" if sg == 2 else "shared")


def _ctx_tables_sparse(s, g, n_ctx):
    """Context tables with frequency 0 for every symbol a row never saw
    (a row that saw one symbol gives it 2^15); rows never used give every
    symbol a frequency."""
    counts = rans.ctx_group_histograms(s, g, n_ctx).cpu().numpy()
    f = np.stack([[rans.quantize_freqs(c, min_all=not c.any()) for c in row]
                  for row in counts]).astype(np.int64)
    c = np.concatenate([np.zeros((*f.shape[:2], 1), np.int64),
                        np.cumsum(f, axis=2)[..., :255]], axis=2)
    return f, c


@pytest.mark.parametrize("g,sg,l,n_ctx,kind", [
    (1, 1100, GT + 1, 4, "normal"), (17, 512, GT - 1, 15, "normal"),
    (64, 264, GT, 15, "walk"), (1, 1099, 1, 4, "walk"),
    (512, 2, GT + 1, 4, "normal"), (2, 550, GT + 1, 4, "const"),
    (3, 100, GT + 1, 15, "normal")])
def test_ctx_grid_decode_paths_match_plain_version(dev, g, sg, l, n_ctx,
                                                   kind):
    """The context mode on every path, with tables whose rows give
    frequency 0 to every symbol they never saw: tiles around GT, 32, 64
    and 128 lanes a block, a ragged S, global tables (sg = 2: 16 groups a
    32-lane block), buckets of 8, 32 and 128 slots (15 classes whose
    128-lane blocks span two groups: S = 16896, past 48 KiB, the opt-in),
    and one symbol at 2^15 ("const")."""
    rng = np.random.default_rng(g + sg + l + n_ctx)
    if kind == "const":
        syms = np.full((g * sg, l), 128, np.uint8)
    elif kind == "walk":
        syms = _ctx_case(g, sg, l, n_ctx, seed=g + l)[0]
    else:
        syms = (128 + rng.normal(0, 20, (g * sg, l))).clip(0, 255).astype(
            np.uint8)
    s = torch.from_numpy(syms).to(dev)
    fg, cg = _ctx_tables_sparse(s, g, n_ctx)
    assert (fg == 0).any()
    if kind == "const":
        assert (fg[:, 0, 128] == 1 << 15).all()
    ft, ct = _tables(dev, fg, cg)
    raw, st = rc.rans_encode_ctx(s, ft, ct)
    before = rc.rans_decode_ctx_grid.launches
    out = rc.rans_decode_ctx_grid(raw, st, ft, ct, l)
    assert rc.rans_decode_ctx_grid.launches == before + 1
    assert torch.equal(out, s)
    assert torch.equal(rc.rans_decode_ctx_grid_ref(raw, st, ft, ct, l), s.t())
    plan = _grid_plan_on(dev, g * sg, g, n_ctx)
    assert plan["tables"] == ("global" if sg == 2 else "shared")
    if g * sg == 16896:
        assert plan["lanes"] == 128 and plan["smem"] > 48 * 1024
        assert plan["shift"] == 7


def test_ctx_grid_decode_rejects_a_bad_grid(dev):
    syms = _ctx_case(4, 64, 8, 4, seed=5)[0]
    s = torch.from_numpy(syms).to(dev)
    fg, cg = rans.ctx_freqs_from_counts(
        rans.ctx_group_histograms(s, 4, 4).cpu().numpy())
    ft, ct = _tables(dev, fg, cg)
    raw, st = rc.rans_encode_ctx(s, ft, ct)
    assert torch.equal(rc.rans_decode_ctx_grid(raw, st, ft, ct, 8), s)
    bad = raw.clone()
    t, lane = (bad >> 16).nonzero()[0].tolist()
    bad[t, lane] &= 0xFFFF
    with pytest.raises(ValueError, match="emit flags"):
        rc.rans_decode_ctx_grid(bad, st, ft, ct, 8)
    st_bad = st ^ 1      # every lane's state off by one bit
    with pytest.raises(ValueError, match="emit flags"):
        rc.rans_decode_ctx_grid(raw, st_bad, ft, ct, 8)


# ---------------------------------------------------------------------------
# Quantizers on the card (no kernels: torch ops that must give the CPU's
# bits, or, for k-means, its labels save near-ties)
# ---------------------------------------------------------------------------

def test_lloydmax_past_float32_sums_equals_cpu(dev):
    """Moments far past 2^24 (a 1088x1920x8 frame's counts): the float64
    sums give the same levels on the card as on the CPU."""
    from vcf_tpu_torch.ops import quantize as q_ops

    rng = np.random.default_rng(2)
    hist = torch.from_numpy(rng.integers(0, 2_000_000, (3, 4096)))
    cpu = q_ops.lloydmax_train_from_hist(hist, 32, -2048, 2047)
    card = q_ops.lloydmax_train_from_hist(hist.to(dev), 32, -2048, 2047)
    assert torch.equal(card.cpu(), cpu)


@pytest.mark.parametrize("kw", [dict(quantizer="lloydmax", entropy="zlib"),
                                dict(quantizer="none", entropy="zlib")])
def test_xla_order_flows_on_cuda_equal_cpu(dev, kw):
    """The Lloyd-Max and no-quantizer DCT flows run vcf_tpu's CPU float
    order in float64 ops: the card's stream and frame are the CPU's."""
    img = make_test_image(1088, 1920, seed=3)
    x = torch.from_numpy(img).to(torch.float32)
    np.testing.assert_array_equal(
        dct_ops.analyze_xla(x.to(dev), 8).cpu().numpy(),
        dct_ops.analyze_xla(x, 8).numpy())
    gpu, cpu = Codec(CodecConfig(**kw), dev), Codec(CodecConfig(**kw), "cpu")
    cs = gpu.encode(img)
    assert cs.to_bytes() == cpu.encode(img).to_bytes()
    np.testing.assert_array_equal(gpu.decode(cs), cpu.decode(cs))


def test_palette_kmeans_on_cuda_matches_cpu(dev):
    from vcf_tpu_torch.ops import prng, vq

    px = torch.from_numpy(make_test_image(544, 960, seed=3).reshape(-1, 3)
                          .astype(np.float32))
    c_cpu, l_cpu = vq.kmeans(prng.PRNGKey(1), px, 32)
    c_gpu, l_gpu = vq.kmeans(prng.PRNGKey(1), px.to(dev), 32)
    agree = (l_gpu.cpu() == l_cpu).double().mean().item()
    assert agree >= 0.999
    assert (c_gpu.cpu() - c_cpu).abs().max().item() < 1.0


@pytest.mark.parametrize("name", ["srans", "ihuff"])
@pytest.mark.parametrize("dtype,sparsity", [(np.uint8, 0.9), (np.uint8, 0.5),
                                            (np.uint16, 0.99)])
def test_device_entropy_bytes_on_cuda_equal_cpu(dev, name, dtype, sparsity):
    """srans (K1, K2 and K3 with one table) and ihuff (torch ops) write the
    CPU's bytes on the card and decode each other's streams."""
    rng = np.random.default_rng(7)
    hi = 256 if dtype == np.uint8 else 65536
    arr = rng.integers(0, hi, (136, 240, 3)).astype(dtype)
    arr[rng.random(arr.shape) < sparsity] = 128
    gpu, cpu = entropy.get(name, device=dev), entropy.get(name, device="cpu")
    counts = (re_.rans_encode_grouped, re_.rans_compact,
              rd.rans_decode_grouped)
    before = [f.launches for f in counts]
    payload, side = gpu.encode(arr)
    assert (payload, side) == cpu.encode(arr)
    np.testing.assert_array_equal(gpu.decode(payload, side), arr)
    launched = [f.launches - b for f, b in zip(counts, before)]
    if name == "srans":
        assert all(n > 0 for n in launched), launched
    else:
        assert launched == [0, 0, 0]


def test_full_fp32_refuses_cudnn_tf32_on_cuda(dev):
    """ROADMAP rule 3 for convolutions: a CUDA Codec refuses cuDNN TF32,
    and NLM's conv then runs in full float32 (the card equals the CPU
    within float32 sum order)."""
    from vcf_tpu_torch.ops import filters
    from vcf_tpu_torch.pipeline import check_full_fp32

    torch.backends.cudnn.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="cudnn.allow_tf32"):
            Codec(CodecConfig(filter="nlm"), dev)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    check_full_fp32()
    img = make_test_image(64, 96, seed=2)
    out_gpu = filters.nlm(torch.from_numpy(img).to(dev), 10.0, 7, 7).cpu()
    out_cpu = filters.nlm(torch.from_numpy(img), 10.0, 7, 7)
    assert (out_gpu - out_cpu).abs().max().item() < 1e-3


@pytest.mark.parametrize("kw", [
    dict(spatial="mdct", entropy="zlib"),
    dict(spatial="klt", entropy="zlib"),
    dict(spatial="lbt", lbt_epochs=50, entropy="zlib"),
    dict(qss=64, entropy="zlib", filter="gaussian"),
    dict(qss=64, entropy="zlib", filter="bm3d")])
def test_new_flows_on_cuda_decode_like_cpu(dev, kw):
    """KLT, MDCT, LBT and the filters on the card: each stream decodes on
    both devices under the pixel rule (the filters under the filter rule
    of tests/test_torch_filters.py: a BM3D coefficient on its threshold
    may flip, |d| <= 2 on at most 0.1% of pixels, else <= 1), and the
    card's decode is deterministic."""
    img = make_test_image(136, 240, seed=3)
    gpu, cpu = Codec(CodecConfig(**kw), dev), Codec(CodecConfig(**kw), "cpu")
    cs = CodeStream.from_bytes(gpu.encode(img).to_bytes())
    rec_g, rec_c = gpu.decode(cs), cpu.decode(cs)
    for rec in (rec_g, rec_c):
        assert rec.shape == img.shape and rec.dtype == np.uint8
    np.testing.assert_array_equal(gpu.decode(cs), rec_g)
    d = np.abs(rec_g.astype(np.int64) - rec_c)
    if "filter" in kw:
        assert d.max() <= 2 and np.count_nonzero(d > 1) <= 1e-3 * d.size
    else:
        assert d.max() <= 1 and np.count_nonzero(d) <= 1e-3 * d.size
    assert abs(metrics.rmse(img, gpu.decode(cs))
               - metrics.rmse(img, cpu.decode(cpu.encode(img)))) < 0.5


def test_bm3d_on_cuda_holds_the_c13_rule(dev):
    """ROADMAP C13: BM3D's block distances and Wiener weights take one
    order on every device, so the card's filter equals the CPU's but for
    the float32 matmuls of the 3-D transforms: on a decoded crop |d| <= 1
    on at most 0.05% of pixels, none past 1; the distances and the weights
    themselves bit for bit."""
    from vcf_tpu_torch.ops import filters

    img = make_test_image(136, 240, seed=3)
    plain = Codec(CodecConfig(qss=64, entropy="zlib"), "cpu")
    part = plain.decode(plain.encode(img))
    x = torch.from_numpy(part).to(torch.float32)
    luma = color_ops.fma_rows(x, filters.LUMA_WEIGHTS[None]).squeeze(-1)
    disps = filters.displacements(8)
    assert torch.equal(filters.block_distances(luma.to(dev), disps, 8).cpu(),
                       filters.block_distances(luma, disps, 8))
    cg3 = torch.from_numpy(np.random.default_rng(1).normal(
        0, 40, (8, 136, 240, 3)).astype(np.float32))
    for a, b in zip(filters.wiener_weights(cg3.to(dev), 25.0, 8),
                    filters.wiener_weights(cg3, 25.0, 8)):
        assert torch.equal(a.cpu(), b)
    cfg = CodecConfig(qss=64, entropy="zlib", filter="bm3d")
    out_g = filters.get(cfg, dev)(part)
    d = np.abs(out_g.astype(np.int64) - filters.get(cfg, "cpu")(part))
    assert d.max() <= 1 and np.count_nonzero(d) <= 5e-4 * d.size
    np.testing.assert_array_equal(filters.get(cfg, dev)(part), out_g)


def test_cli_default_device_writes_the_codec_stream(dev, tmp_path):
    """`vcf_tpu_torch.cli.main` with no --device runs on the card: its file
    is the stream of Codec(..., device="cuda"), and its decode that
    Codec's decode."""
    from vcf_tpu_torch.cli import main
    from vcf_tpu_torch.io import read_image, write_image

    img = make_test_image(64, 96, seed=2)
    png, enc, dec = (str(tmp_path / n) for n in ("o.png", "enc", "dec.png"))
    write_image(png, img)
    assert main(["encode", "-o", png, "-e", enc, "-c", "grans"]) == 0
    codec = Codec(CodecConfig(entropy="grans"), "cuda")
    cs = codec.encode(img)
    with open(enc, "rb") as f:
        assert f.read() == cs.to_bytes()
    assert main(["decode", "-e", enc, "-d", dec, "-c", "grans"]) == 0
    np.testing.assert_array_equal(read_image(dec), codec.decode(cs))


def test_cli_turns_tf32_off_before_building_a_codec(dev, tmp_path,
                                                    monkeypatch):
    """The CLI owns its process: on the card it turns TF32 off in matmuls
    and cuDNN and sets the "highest" matmul precision before it builds a
    codec, which would refuse CUDA otherwise."""
    from vcf_tpu_torch import cli, pipeline
    from vcf_tpu_torch.io import write_image

    seen = []
    init = pipeline.Codec.__init__

    def spy(self, *args, **kwargs):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32,
                     torch.get_float32_matmul_precision()))
        init(self, *args, **kwargs)

    monkeypatch.setattr(pipeline.Codec, "__init__", spy)
    png = str(tmp_path / "o.png")
    write_image(png, make_test_image(32, 48, seed=1))
    old = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        assert cli.main(["encode", "-o", png, "-e", str(tmp_path / "e"),
                         "-c", "zlib"]) == 0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision(old)
    assert seen == [(False, False, "highest")]


# ---------------------------------------------------------------------------
# Meshes on the card: 4 shards on cuda:0 run one after another there, each
# through the same kernels as the one-device batch, so the outputs are equal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(quantizer="lloydmax")],
                         ids=["cdct-route", "lloydmax"])
def test_batch_codec_on_a_cuda_mesh_equals_one_device(dev, kw):
    from vcf_tpu_torch.parallel import Mesh

    frames = np.stack([make_test_image(61, 90, seed=i) for i in range(6)])
    cfg = CodecConfig(entropy="zlib", **kw)
    mesh = Mesh((dev,) * 4)
    for shared in ((False, True) if kw else (False,)):
        one = BatchCodec(cfg, dev, shared_levels=shared)
        sharded = BatchCodec(cfg, dev, mesh=mesh, shared_levels=shared)
        before = dk.fused_cdct_quantize.launches
        planes = sharded.encode_planes(frames)
        if not kw:
            assert dk.fused_cdct_quantize.launches - before == 4
        np.testing.assert_array_equal(planes, one.encode_planes(frames))
        for key, value in one.last_qside.items():
            np.testing.assert_array_equal(sharded.last_qside[key], value)
        np.testing.assert_array_equal(
            sharded.decode_planes(planes, original_hw=(61, 90)),
            one.decode_planes(planes, original_hw=(61, 90)))


def test_ipp_on_a_cuda_mesh_equals_one_device(dev):
    from vcf_tpu_torch.parallel import Mesh

    frames = make_test_video(6, 64, 96)
    vcfg = VideoConfig(mode="ipp", n_frames=6, gop_size=2, search_range=4)
    ccfg = CodecConfig(entropy="grans")
    one = video.IPPCodec(vcfg, ccfg, dev)
    sharded = video.IPPCodec(vcfg, ccfg, dev, mesh=Mesh((dev,) * 4))
    cs = sharded.encode(frames)
    assert cs.to_bytes() == one.encode(frames).to_bytes()
    rec = sharded.decode(CodeStream.from_bytes(cs.to_bytes()))
    np.testing.assert_array_equal(
        rec, sharded.last_recon.to(torch.uint8).cpu().numpy())
    np.testing.assert_array_equal(rec, one.decode(cs))


def test_make_mesh_raises_past_the_cards(dev):
    from vcf_tpu_torch.parallel import make_mesh

    assert make_mesh().size == torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="cuda devices"):
        make_mesh(torch.cuda.device_count() + 1)


def _trace_events(prof, path) -> list:
    import json

    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_rans_read_backs_count_once_a_call_on_the_trace_clock(dev, tmp_path):
    """A wire encode (K1, the row mode, assemble_stream), a K3 decode and a
    grid decode each read the card back once: `host_syncs` grows by 1 a
    call.  In a profiler trace each `vcf.rans.sync` span launches one
    device-to-host copy, which ends inside the span's host interval: the
    codec's spans and the device items share one clock."""
    from torch.profiler import ProfilerActivity, profile
    from vcf_tpu_torch.utils import profiling

    g, sg, l = 64, 16, 24
    syms, fg, cg = _case(g, sg, l, seed=11)
    s = torch.from_numpy(syms).to(dev)
    ft = torch.from_numpy(fg.astype(np.int64)).to(dev)
    ct = torch.from_numpy(cg.astype(np.int64)).to(dev)
    added = []

    def counted(fn):
        before = profiling.counts()["host_syncs"]
        out = fn()
        added.append(profiling.counts()["host_syncs"] - before)
        return out

    def wire_encode():
        rows, counts, st = re_.rans_encode_rows(s, ft, ct)
        return (*re_.assemble_stream(rows, counts), st, counts)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        words, n_words, st, counts = counted(wire_encode)
        n = int(n_words)
        out = counted(lambda: rd.rans_decode_grouped(words[:n], st, ft, ct,
                                                     l, counts))
        raw, st_raw = re_.rans_encode_grouped(s, ft, ct)
        grid = counted(lambda: rd.rans_decode_grouped_grid(raw, st_raw, ft,
                                                           ct, l))
        torch.cuda.synchronize(dev)
    assert added == [1, 1, 1]
    assert torch.equal(out, s) and torch.equal(grid, s)

    events = _trace_events(prof, tmp_path / "trace.json")
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"vcf.rans.encode", "vcf.rans.compact", "vcf.rans.assemble",
            "vcf.rans.decode", "vcf.rans.tables", "vcf.rans.layout",
            "vcf.rans.sync"} <= names
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "DtoH" in e.get("name", "")]
    syncs = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] == "vcf.rans.sync"]
    assert len(syncs) == 3
    for sp in syncs:
        a, b = sp["ts"], sp["ts"] + sp["dur"]
        inside = [c for c in copies
                  if a <= launch_ts.get(c["args"].get("correlation"), -1) <= b]
        assert len(inside) == 1, inside
        end = inside[0]["ts"] + inside[0]["dur"]
        assert a <= end <= b, (a, end, b)


def test_layout_bytes_count_the_card_copies(dev):
    """The DCT wrapper's planar copy, the lanes' copy and K1's (L, S) copy
    each add their bytes read and written; contiguous inputs add nothing."""
    from vcf_tpu_torch.utils import profiling

    def added(fn):
        before = profiling.counts()["layout_bytes"]
        out = fn()
        return out, profiling.counts()["layout_bytes"] - before

    clip = torch.from_numpy(make_test_video(2, 64, 256, seed=3)).to(dev)
    n = clip.numel()
    mat = dk.static_mat(color_ops.YCOCG_FWD)
    planes, got = added(lambda: dk.fused_cdct_quantize(
        clip.permute(0, 3, 1, 2), mat, grid_layout=True))
    assert got == 2 * n
    again, got = added(lambda: dk.fused_cdct_quantize(
        clip.permute(0, 3, 1, 2).contiguous(), mat, grid_layout=True))
    assert got == 0 and torch.equal(again, planes)
    lanes, got = added(lambda: rans.grid_lanes_lmajor(
        planes, 8, 1024, cw=dk._chunk_w(256, 8)))
    assert got == 2 * n
    fg, cg = rans.freqs_from_counts(
        rans.group_histograms(lanes.t(), 64).cpu().numpy())
    ft = torch.from_numpy(fg.astype(np.int64)).to(dev)
    ct = torch.from_numpy(cg.astype(np.int64)).to(dev)
    (raw, st), got = added(lambda: re_.rans_encode_grouped(lanes.t(), ft, ct))
    assert got == 2 * n
    (raw2, st2), got = added(lambda: re_.rans_encode_grouped(
        lanes.contiguous().t(), ft, ct))
    assert got == 0 and torch.equal(raw2, raw) and torch.equal(st2, st)


# The luma kernel (csrc/motion.cu luma_kernel): bit for bit against its
# plain version, `to_luma` (fma_rows' chain) after `torch.round` when
# rounding, compared as int32 bits.
LUMA_MODES = {0: "planar", 1: "channels_last", 2: "scalar"}


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


@functools.lru_cache(maxsize=1)
def _every_rgb():
    """Every RGB triple as one (1, 4096, 4096, 3) u8 frame, and the bits
    of its luma by `to_luma` on the CPU."""
    v = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1)
    frame = torch.from_numpy(rgb.astype(np.uint8).reshape(1, 4096, 4096, 3))
    return frame, _bits(motion.to_luma(frame))


def _luma_mode_equal(x, axis):
    """The mode the C entry picks equals the wrapper's mirror; returns it."""
    xs, strides = lk.frames_of(x, axis)
    c = _build.load().vcf_luma_mode(xs.data_ptr(), lk.DTYPES[x.dtype],
                                    *xs.shape[:3], *strides)
    mode = lk.launch_mode(xs.data_ptr(), x.dtype, xs.shape[:3], strides)
    assert LUMA_MODES[c] == mode
    return mode


@pytest.mark.parametrize("round_", [False, True])
@pytest.mark.parametrize("layout", ["planar", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_luma_kernel_every_rgb_triple(dev, dtype, layout, round_):
    frame, want = _every_rgb()
    if layout == "planar":
        x, axis = frame.permute(0, 3, 1, 2).to(dtype).contiguous().to(dev), -3
    else:
        # a frame of a (G, T, H, W, 3) clip: a strided channels-last view
        clip = torch.zeros((1, 2, 4096, 4096, 3), dtype=dtype, device=dev)
        clip[:, 1] = frame.to(dev)
        x, axis = clip[:, 1], -1
    assert _luma_mode_equal(x, axis) == layout
    launches = lk.luma.launches
    got = lk.luma(x, axis, round=round_)
    torch.cuda.synchronize()
    assert lk.luma.launches == launches + 1
    assert got.shape == (1, 4096, 4096) and got.is_contiguous()
    assert torch.equal(_bits(got).cpu(), want)


def test_luma_kernel_half_integers_and_negatives_under_round(dev):
    rng = np.random.default_rng(21)
    half = torch.from_numpy(
        (rng.integers(-41, 2 * 255 + 41, (3, 3, 64, 256)) / 2).astype(
            np.float32))
    for x, axis in ((half, -3), (half.permute(0, 2, 3, 1).contiguous(), -1)):
        for round_ in (True, False):
            got = lk.luma(x.to(dev), axis, round=round_)
            want = lk.luma_ref(x, axis, round=round_)
            assert torch.equal(_bits(got).cpu(), _bits(want))


def test_luma_kernel_scalar_mode(dev):
    """Odd widths, misaligned views and other strides take the scalar mode
    of the same kernel, counted in generic_launches; equal bit for bit."""
    rng = np.random.default_rng(22)

    def pixels(*shape, dtype=np.float32):
        return torch.from_numpy(rng.integers(0, 256, shape).astype(dtype)
                                ).to(dev)

    cases = [
        (pixels(2, 3, 5, 37), -3),                           # W % 4 != 0
        (pixels(2, 5, 37, 3, dtype=np.uint8), -1),
        (pixels(2, 5, 26, 3, dtype=np.uint8), -1),
        (pixels(2 * 3 * 8 * 64 + 1)[1:].view(2, 3, 8, 64), -3),
        (pixels(2 * 8 * 64 * 3 + 3, dtype=np.uint8)[3:].view(2, 8, 64, 3),
         -1),                                                # 3 bytes off
        (pixels(2 * 3 * 8 * 64 + 2, dtype=np.uint8)[2:].view(2, 3, 8, 64),
         -3),
        (pixels(2, 8, 64, 6)[..., ::2], -1),                 # pixel stride 6
        (pixels(2, 3, 8, 65)[..., :64], -3),                 # rows of 65
    ]
    for x, axis in cases:
        assert _luma_mode_equal(x, axis) == "scalar"
        for round_ in (False, True):
            before = (lk.luma.launches, lk.luma.generic_launches)
            got = lk.luma(x, axis, round=round_)
            torch.cuda.synchronize()
            assert (lk.luma.launches, lk.luma.generic_launches) == (
                before[0] + 1, before[1] + 1)
            assert torch.equal(_bits(got).cpu(),
                               _bits(lk.luma_ref(x.cpu(), axis, round_)))


def test_luma_kernel_u8_views_at_4_byte_offsets(dev):
    """A uint8 quad is 4 bytes: views 4 bytes off a 16-byte boundary keep
    the vector modes, with a non-multiple of 16 for W."""
    rng = np.random.default_rng(24)
    flat = torch.from_numpy(rng.integers(0, 256, 2 * 8 * 20 * 3 + 4).astype(
        np.uint8)).to(dev)
    for x, axis, mode in ((flat[4:].view(2, 8, 20, 3), -1, "channels_last"),
                          (flat[4:].view(2, 3, 8, 20), -3, "planar")):
        assert _luma_mode_equal(x, axis) == mode
        generic = lk.luma.generic_launches
        got = lk.luma(x, axis)
        assert lk.luma.generic_launches == generic
        assert torch.equal(_bits(got).cpu(), _bits(lk.luma_ref(x.cpu(), axis)))


def test_ipp_planar_loop_luma_kernel_equals_fma_rows(dev, monkeypatch):
    """The planar grid loop on a 2-GOP 1088x1920 clip: the same planes,
    mvs and reconstruction with the kernel's lumas as with fma_rows',
    and two vector-mode launches a P step."""
    gop = 4
    frames = make_test_video(2 * gop, 1088, 1920, seed=23)
    vcfg = VideoConfig(mode="ipp", n_frames=2 * gop, gop_size=gop)
    ipp = video.get(vcfg, CodecConfig(entropy="grans"), dev)
    gops = torch.from_numpy(frames).to(dev).reshape(2, gop, 1088, 1920, 3)
    before = (lk.luma.launches, lk.luma.generic_launches)
    planes, mvs = ipp._gop_encode_grid_batch(gops)
    torch.cuda.synchronize()
    assert (lk.luma.launches, lk.luma.generic_launches) == (
        before[0] + 2 * (gop - 1), before[1])
    recon = ipp.last_grid_recon
    monkeypatch.setattr(lk, "luma", lk.luma_ref)
    planes_p, mvs_p = ipp._gop_encode_grid_batch(gops)
    assert torch.equal(planes, planes_p) and torch.equal(mvs, mvs_p)
    assert torch.equal(_bits(recon), _bits(ipp.last_grid_recon))


# The DWT level kernels (csrc/dwt.cu, ops/cuda/dwt_kernel.py): every band
# bit for bit against the plain torch chain (`ops.dwt.analyze_level_ref`),
# every synthesis output equal to it (the kernel skips the zero terms of
# the upsampled bands, which may flip only the sign of a zero sum).
DWT_FAMILIES = ["haar", "db2", "db5", "sym4", "coif2", "bior2.2",
                "legall53", "bior4.4", "cdf97", "rbio3.5"]


def _dwt_signal(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random(shape) * 255 - 128)
                            .astype(np.float32))


def _dwt_level_equal(x, bank, axis, dev):
    """One level of `x` (CPU) by the kernels on `dev` and by the plain
    chain on the CPU: bands bit for bit, synthesis equal."""
    got = dwt_ops.analyze_level(x.to(dev), bank, axis)
    want = dwt_ops.analyze_level_ref(x, bank, axis)
    for g, w in zip((got[0],) + got[1], (want[0],) + want[1]):
        assert g.shape == w.shape and g.stride() == w.stride()
        assert torch.equal(_bits(g).cpu(), _bits(w))
    hw = x.shape[axis:axis + 2]
    y = dwt_ops.synthesize_level(want[0].to(dev),
                                 tuple(d.to(dev) for d in want[1]), bank, hw,
                                 axis)
    assert torch.equal(y.cpu(), dwt_ops.synthesize_level_ref(
        want[0], want[1], bank, hw, axis))


@pytest.mark.parametrize("name", DWT_FAMILIES)
def test_dwt_level_kernels_match_plain_chain(dev, name):
    bank = dwt_ops.get_bank(name)
    before = (dwk.analyze_level.launches, dwk.synthesize_level.launches)
    seed, calls = 0, 0
    for axis, lead in ((0, ()), (1, (1,)), (1, (3,))):
        for t in (1, 3):
            for hw in ((32, 48), (34, 60), (2, 4), (66, 130), (16, 400)):
                seed += 1
                calls += 1
                _dwt_level_equal(_dwt_signal(lead + hw + (t,), seed), bank,
                                 axis, dev)
    assert (dwk.analyze_level.launches, dwk.synthesize_level.launches) == (
        before[0] + calls, before[1] + calls)


def test_dwt_level_kernels_plans_by_shape(dev):
    """Tile geometry from the shape and the bank: the cell's levels staged
    in one tile of 16 x 32 (analysis) or 32 x 64 (synthesis) output rows x
    columns; a 2 x 4 level in a tile cut to it; 600 trailing elements in
    chunks; a 300-tap bank read from device memory; each bit for bit."""
    def plan(bank, synthesis, b, rows, cols, t):
        ints = dwt_ops.kernel_args(bank, rows, cols, synthesis)[1]
        out = (ctypes.c_longlong * 8)()
        _build.check(_build.load().vcf_dwt_plan(
            int(synthesis), (ctypes.c_int * len(ints))(*ints), b, rows, cols,
            t, out), "vcf_dwt_plan")
        return list(out)

    db5 = dwt_ops.get_bank("db5")
    an, sy = plan(db5, False, 8, 1088, 1920, 3), plan(db5, True, 8, 544, 960,
                                                      3)
    assert an[:6] == [16, 32, 3, 40, 72, 1]
    assert sy[:6] == [32, 64, 3, 21, 37, 1]
    assert plan(db5, False, 8, 68, 120, 3)[:3] == [16, 32, 3]
    assert plan(db5, False, 1, 2, 4, 3)[:3] == [1, 2, 3]
    assert plan(db5, True, 1, 1, 2, 3)[:3] == [2, 4, 3]
    chunked = plan(db5, False, 1, 8, 8, 600)
    assert chunked[2] < 600 and chunked[5] == 1
    rng = np.random.default_rng(3)
    long = dwt_ops.Bank(*(rng.normal(size=n) for n in (300, 290, 301, 299)),
                        -7, 3, -5, 2)
    assert plan(long, False, 1, 16, 16, 3)[5] == 0
    assert plan(long, True, 1, 8, 8, 3)[5] == 0
    _dwt_level_equal(_dwt_signal((8, 8, 600), 1), db5, 0, dev)
    _dwt_level_equal(_dwt_signal((16, 16, 3), 2), long, 0, dev)


def test_dwt_level_kernels_at_the_cells_shape(dev):
    """Five db5 levels of an 8 x 1088 x 1920 x 3 clip, the cell's shapes,
    against the plain chain on the card."""
    bank = dwt_ops.get_bank("db5")
    gen = torch.Generator(device=dev).manual_seed(7)
    cur = torch.rand((8, 1088, 1920, 3), device=dev, generator=gen) * 255 \
        - 128
    for _ in range(5):
        got = dwt_ops.analyze_level(cur, bank, 1)
        want = dwt_ops.analyze_level_ref(cur, bank, 1)
        for g, w in zip((got[0],) + got[1], (want[0],) + want[1]):
            assert torch.equal(_bits(g), _bits(w))
        hw = tuple(cur.shape[1:3])
        assert torch.equal(
            dwt_ops.synthesize_level(got[0], got[1], bank, hw, 1),
            dwt_ops.synthesize_level_ref(got[0], got[1], bank, hw, 1))
        cur = got[0]


def _plain_bank(monkeypatch):
    monkeypatch.setattr(dwt_ops, "analyze_level", dwt_ops.analyze_level_ref)
    monkeypatch.setattr(dwt_ops, "synthesize_level",
                        dwt_ops.synthesize_level_ref)


def test_dwt_clip_path_kernels_equal_the_plain_chain(dev, monkeypatch):
    """The cell's clip path (8 HD frames, db5, 5 levels): lanes and u8
    frames byte-identical with the plain chain's on the card, and 5
    launches of each kernel a call."""
    codec = Codec(CodecConfig(spatial="dwt", entropy="cgrans"), device=dev)
    base = make_test_image(1088, 1920, seed=3)
    clip = torch.from_numpy(np.stack([np.roll(base, (7 * i, 13 * i), (0, 1))
                                      for i in range(8)])).to(dev)
    shape = tuple(clip.shape[1:])
    before = (dwk.analyze_level.launches, dwk.synthesize_level.launches)
    lanes = codec._dwt.clip_to_lanes(codec, clip)
    frames = codec._dwt.lanes_to_clip(codec, lanes, shape)
    torch.cuda.synchronize()
    assert (dwk.analyze_level.launches, dwk.synthesize_level.launches) == (
        before[0] + 5, before[1] + 5)
    _plain_bank(monkeypatch)
    assert torch.equal(lanes, codec._dwt.clip_to_lanes(codec, clip))
    assert torch.equal(frames, codec._dwt.lanes_to_clip(codec, lanes, shape))


def test_dwt_still_device_stream_equals_the_plain_chain(dev, monkeypatch):
    """The still DWT codec's device path (`encode_device`, the clip entries
    with one frame) at 1088 x 1920: the same stream bytes and decoded
    pixels with the kernels as with the plain chain."""
    img = make_test_image(1088, 1920, seed=3)
    codec = Codec(CodecConfig(spatial="dwt", entropy="cgrans"), device=dev)
    blob = codec.encode(img).to_bytes()
    rec = codec.decode(CodeStream.from_bytes(blob))
    _plain_bank(monkeypatch)
    assert codec.encode(img).to_bytes() == blob
    assert np.array_equal(codec.decode(CodeStream.from_bytes(blob)), rec)


# The DWT clip path's two ends (csrc/dwt_ends.cu, ops/cuda/dwt_ends.py):
# each kernel bit for bit against its plain torch chain in ops/dwt.py, on
# the CPU.
DWT_ENDS = (dwe.color_in, dwe.bands_to_lanes, dwe.lanes_to_bands,
            dwe.color_out)


def _end_launches():
    return [fn.launches for fn in DWT_ENDS]


def _dwt_codec(device, **kw):
    return Codec(CodecConfig(spatial="dwt", entropy="cgrans", **kw),
                 device=device)


@pytest.mark.parametrize("color", ["ycocg", "ycrcb", "cdct", "none"])
def test_dwt_color_in_every_rgb_triple(dev, color):
    """The forward colour on every RGB triple, offset 128: fma_rows' float64
    steps on the CPU against the kernel's float32 FMA chain."""
    frame, _ = _every_rgb()
    codec = _dwt_codec("cpu", color=color)
    m = codec._dwt._matrix(codec, False)
    before = dwe.color_in.launches
    got = dwe.color_in(frame.to(dev), m, 128, 32)
    torch.cuda.synchronize()
    assert dwe.color_in.launches == before + 1
    assert got.shape == (1, 4096, 4096, 3) and got.is_contiguous()
    want = codec._dwt._color(codec, frame.to(torch.float32) - 128, False)
    assert torch.equal(_bits(got).cpu(), _bits(want))


def _fma_chain(px: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """(K, 3) float32 pixels through the 3 x 3 matrix `m` as one float32
    FMA chain a row (`ops.dwt.fma32`, exact)."""
    rows = []
    for r in range(3):
        a = px[:, 0] * float(m[r, 0])
        a = dwt_ops.fma32(px[:, 1], float(m[r, 1]), a)
        rows.append(dwt_ops.fma32(px[:, 2], float(m[r, 2]), a))
    return torch.stack(rows, -1)


def _double_roundings(m: np.ndarray) -> torch.Tensor:
    """Pixels on which `fma_rows`' float64 steps and one float32 FMA chain
    give u8 pixels apart after + 128 and the round: for each half-integer
    t - 128 and each side, a product x * m[r, c] next to the float32
    midpoint beside t, and an accumulator a hair from the rest, so that
    the float64 sum lands on the midpoint (then ties to even) while the
    exact sum does not."""
    m64 = np.asarray(m, np.float32).astype(np.float64)
    t = np.repeat(np.arange(256.0) - 127.5, 2)
    u = np.spacing(np.abs(t).astype(np.float32)).astype(np.float64)
    target = t + np.tile([1.0, -1.0], 256) * u / 2
    found = []
    for r in range(3):
        for c in (1, 2):
            if m64[r, c] == 0 or m64[r, 0] == 0:
                continue
            x = (target / m64[r, c]).astype(np.float32)
            rest = target - x.astype(np.float64) * m64[r, c]
            for side in (np.inf, -np.inf):
                acc = np.nextafter(rest.astype(np.float32), side)
                x0 = (acc / m64[r, 0]).astype(np.float32)
                ok = (x0.astype(np.float64) * m64[r, 0]).astype(
                    np.float32) == acc
                px = np.zeros((int(ok.sum()), 3), np.float32)
                px[:, 0], px[:, c] = x0[ok], x[ok]
                found.append(px)
    px = torch.from_numpy(np.concatenate(found))
    steps = torch.round(color_ops.fma_rows(px, m) + 128)
    fused = torch.round(_fma_chain(px, m) + 128)
    return px[((steps != fused) & (steps >= 0) & (steps <= 255)).any(-1)]


@pytest.mark.parametrize("color", ["ycocg", "ycrcb", "cdct", "none"])
def test_dwt_color_out_random_bands(dev, color):
    """The inverse colour, offset, crop, round, clamp and u8 cast on random
    float32 (2, 64, 96, 3) bank outputs cut to 60 x 90 and 61 x 95 (odd
    margins), with ties of the round and, for ycrcb and cdct, pixels whose
    float64 steps and a float32 FMA chain round to u8 values apart."""
    codec = _dwt_codec("cpu", color=color)
    m = codec._dwt._matrix(codec, True)
    rng = np.random.default_rng(25)
    x = torch.from_numpy((rng.normal(0, 90, (2, 64, 96, 3))).astype(
        np.float32))
    x.view(-1)[:4096] = torch.from_numpy(
        (rng.integers(-300, 300, 4096) + 0.5).astype(np.float32))
    if m is not None:
        splits = _double_roundings(m)
        assert (color == "ycocg") == (splits.shape[0] == 0)
        x[0, 20, 10:10 + splits.shape[0]] = splits
    for hw in ((60, 90), (61, 95), (64, 96)):
        before = dwe.color_out.launches
        got = dwe.color_out(x.to(dev), m, 128, hw)
        torch.cuda.synchronize()
        assert dwe.color_out.launches == before + 1
        want = codec._dwt._color(codec, x, True) + 128
        want = dct_ops.unpad_centered(want, hw, 1)
        want = torch.clamp(torch.round(want), 0, 255).to(torch.uint8)
        assert torch.equal(got.cpu(), want)


def _edge_bands(rng, qss, n, sizes):
    """Float32 bands (n frames each) of random values, exact multiples of
    qss and their neighbours, +-0 and, in LL, values past 2^15 steps."""
    bands = []
    for i, m in enumerate(sizes):
        k = rng.integers(-300, 300, n * m).astype(np.float32) * qss
        x = rng.normal(0, 3000 if i == 0 else 200, n * m).astype(np.float32)
        pick = rng.random(n * m)
        x = np.where(pick < 0.3, k, x)
        x = np.where((pick >= 0.3) & (pick < 0.4),
                     np.nextafter(k, np.float32(-np.inf)), x)
        x[:4] = [0.0, -0.0, qss, -qss]
        if i == 0:
            x[4:8] = [-40000.0 * qss, 40000.0 * qss, -(2.0 ** 24), 2.0 ** 24]
        bands.append(torch.from_numpy(x.astype(np.float32)).view(n, m))
    return bands


@pytest.mark.parametrize("qss", [7, 24, 32])
def test_dwt_quantize_grid_edge_values(dev, qss):
    """The quantizer and byte planes into the lane grid against
    `_byte_planes` and `bands_to_grid` on the CPU: +-0, exact multiples
    of qss and the values just below them, LL's 16-bit wrap."""
    from vcf_tpu_torch.entropy import dwt_device as dd

    rng = np.random.default_rng(qss)
    sizes, n, sg, l = [24, 24, 24, 24, 96, 96, 96, 1000], 3, 4, 252
    bands = _edge_bands(rng, qss, n, sizes)
    codec = _dwt_codec("cpu", qss=qss)
    want = dd.bands_to_grid(codec._dwt._byte_planes(codec, bands), sg, l,
                            frames=n)
    before = dwe.bands_to_lanes.launches
    got = dwe.bands_to_lanes([b.to(dev) for b in bands], qss, sg, l)
    torch.cuda.synchronize()
    assert dwe.bands_to_lanes.launches == before + 1
    assert torch.equal(got.cpu(), want)


def test_dwt_dequantize_grid_views(dev):
    """The dequantizer from K3's transposed view of an (L, S) buffer, from
    such a view 1 byte into its buffer and from a contiguous grid: the
    mode the C entry picks equals the wrapper's mirror, and the bands
    equal `_grid_flat` after `grid_to_bands` on the CPU."""
    from vcf_tpu_torch.entropy import dwt_device as dd

    rng = np.random.default_rng(26)
    n, sg, l, qss = 3, 4, 252, 24
    shapes = [(n, 2, 4, 3)] + [(n, 2, 4, 3)] * 3 + [(n, 4, 8, 3)] * 3 \
        + [(n, 25, 13, 3)]
    grid = torch.from_numpy(rng.integers(0, 256, ((len(shapes) + 1) * sg * n,
                                                  l), dtype=np.uint8))
    codec = _dwt_codec("cpu", qss=qss)
    sizes = [int(np.prod(s[1:])) for s in shapes]
    want = codec._dwt._grid_flat(codec, dd.grid_to_bands(
        grid, sizes[:1] + sizes, sg, frames=n), shapes)
    off = torch.zeros((l, grid.shape[0] + 1), dtype=torch.uint8,
                      device=dev)
    off[:, 1:] = grid.t().to(dev)
    for lanes, mode in ((grid.t().contiguous().to(dev).t(), "steps"),
                        (off[:, 1:].t(), "steps"), (grid.to(dev), "lanes")):
        assert dwe.dequantize_mode(lanes) == mode
        assert _build.load().vcf_dwt_dequantize_mode(*lanes.stride()) == (
            mode == "steps")
        before = dwe.lanes_to_bands.launches
        got = dwe.lanes_to_bands(lanes, qss, shapes)
        torch.cuda.synchronize()
        assert dwe.lanes_to_bands.launches == before + 1
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.is_contiguous()
            assert torch.equal(_bits(g).cpu(), _bits(w))


def _sha(t: torch.Tensor) -> str:
    import hashlib

    return hashlib.sha256(t.cpu().contiguous().numpy().tobytes()).hexdigest()


def test_dwt_clip_ends_equal_the_cpu_path(dev):
    """`clip_to_lanes` / `lanes_to_clip` on the card (both ends kernels)
    on a 2-frame 1080 x 1916 clip, which pads, and a 2-frame 61 x 99 clip
    (odd margins): the lanes' and frames' sha256 equal the plain path's
    on the CPU; decoding K3's transposed view and a contiguous grid give
    the same frames."""
    base = make_test_image(1088, 1920, seed=27)
    for h, w in ((1080, 1916), (61, 99)):
        clip = np.stack([np.roll(base, (5 * i, 9 * i), (0, 1))[:h, :w]
                         for i in range(2)])
        gpu, cpu = _dwt_codec(dev), _dwt_codec("cpu")
        shape = clip.shape[1:]
        lanes = gpu._dwt.clip_to_lanes(gpu, torch.from_numpy(clip).to(dev))
        lanes_c = cpu._dwt.clip_to_lanes(cpu, torch.from_numpy(clip))
        assert _sha(lanes) == _sha(lanes_c)
        frames = gpu._dwt.lanes_to_clip(gpu, lanes, shape)
        frames_t = gpu._dwt.lanes_to_clip(gpu, lanes.t().contiguous().t(),
                                          shape)
        want = _sha(cpu._dwt.lanes_to_clip(cpu, lanes_c, shape))
        assert _sha(frames) == _sha(frames_t) == want


def test_dwt_clip_ends_launch_once_and_copy_no_grid(dev, tmp_path):
    """A card call of the clip path launches 1 colour, 5 bank and 1 grid
    kernel on encode and 1 dequantizer, 5 bank and 1 colour kernel on
    decode, each in its `vcf.dwt.*` span and no `vcf.dwt.layout` span:
    `layout_bytes` grows by K1's (L, S) copy alone on encode (2 bytes a
    grid slot) and by nothing on decode."""
    import json

    from vcf_tpu_torch.entropy import dwt_device as dd
    from vcf_tpu_torch.utils import profiling

    codec = _dwt_codec(dev)
    dwt = codec._dwt
    clip = torch.from_numpy(np.stack([make_test_image(64, 128, seed=s)
                                      for s in (41, 42)])).to(dev)
    shape = tuple(clip.shape[1:])
    lanes0 = dwt.clip_to_lanes(codec, clip)
    g = len(dwt._grid_sizes(shape))
    fg, cg = (torch.from_numpy(t.astype(np.int64)).to(dev)
              for t in dd.train_ctx_tables(lanes0.cpu(), g, 4))
    bank = (dwk.analyze_level, dwk.synthesize_level)
    logs, launches = [], []
    for call in ("encode", "decode"):
        ends = _end_launches()
        levels = [fn.launches for fn in bank]
        with profiling.trace(str(tmp_path / call)):
            c0 = profiling.counts()["layout_bytes"]
            if call == "encode":
                lanes = dwt.clip_to_lanes(codec, clip)
                stream = rans.encode_lanes_device(lanes, fg, cg)
            else:
                words, n_words, counts, states = stream
                out = rc.rans_decode_ctx(words[:int(n_words)], states, fg, cg,
                                         lanes.shape[1], counts)
                frames = dwt.lanes_to_clip(codec, out, shape)
            torch.cuda.synchronize()
            logs.append(profiling.counts()["layout_bytes"] - c0)
        launches.append([a - b for a, b in zip(_end_launches(), ends)]
                        + [fn.launches - b for fn, b in zip(bank, levels)])
        with open(tmp_path / call / "trace.json") as f:
            names = [e["name"] for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "user_annotation" and "dur" in e]
        want = ({"vcf.dwt.analyze": 1, "vcf.dwt.bank": 5,
                 "vcf.dwt.layout": 0, "vcf.rans.encode": 1,
                 "vcf.rans.compact": 1}
                if call == "encode" else
                {"vcf.rans.decode": 1, "vcf.dwt.layout": 0,
                 "vcf.dwt.bank": 5, "vcf.dwt.synthesize": 1})
        assert {k: names.count(k) for k in want} == want, names
    assert launches == [[1, 1, 0, 0, 5, 0], [0, 0, 1, 1, 0, 5]]
    assert torch.equal(lanes, lanes0)
    assert torch.equal(frames, dwt.lanes_to_clip(codec, lanes0, shape))
    assert logs == [2 * lanes0.numel(), 0]
