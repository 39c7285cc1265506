"""The port's entropy codecs against vcf_tpu's on identical index planes.

Entropy coding is exact: on the same uint8 index planes both packages
must write the same payload and sidecar bytes (tolerance 0), and each
must decode the other's stream.  The planes are real DCT index planes
(vcf_tpu's forward transform) so the grouped codec sees subband
statistics; the grouped cases are sized so that lanes group
(256x256 -> S=256, sg=4), unlike the 96x112 golden, which takes the
dense fallback.
"""

import zlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import vcf_tpu
from vcf_tpu.entropy import get as jget
from vcf_tpu.entropy import rans as jrans
from vcf_tpu.io import test_image as make_test_image
from vcf_tpu.ops import dct as jdct
import vcf_tpu_torch.entropy as tentropy
from vcf_tpu_torch.entropy import rans as trans

CPU = torch.device("cpu")


def _planes(h, w, seed):
    """vcf_tpu's stored u8 index planes of test_image(h, w, seed)."""
    codec = vcf_tpu.Codec(vcf_tpu.CodecConfig(entropy="grans"))
    img = jnp.asarray(make_test_image(h, w, seed=seed), jnp.float32)
    k = np.asarray(codec._q(codec._analyze(jdct.pad_centered(img, 8))))
    return np.clip(k + 128, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def frame():
    return _planes(256, 256, seed=1)


@pytest.fixture(scope="module")
def batch():
    return np.stack([_planes(128, 256, seed=2), _planes(128, 256, seed=4)])


def _pair(name):
    return jget(name), tentropy.get(name, device=CPU)


def _same_bytes_and_roundtrip(name, arr):
    jc, tc = _pair(name)
    pj, sj = jc.encode(arr)
    pt, st = tc.encode(arr)
    assert pt == pj
    assert st == sj
    out = tc.decode(pj, sj)
    assert out.dtype == arr.dtype and np.array_equal(out, arr)
    assert np.array_equal(np.asarray(jc.decode(pt, st)), arr)
    return st


@pytest.mark.parametrize("name", ["grans", "rans", "tiff", "zlib"])
def test_frame_bytes_identical(name, frame):
    side = _same_bytes_and_roundtrip(name, frame)
    if name == "grans":
        assert side["grans_model"][0] == 2      # grouped lanes, v2 sidecar


@pytest.mark.parametrize("name", ["grans", "rans"])
def test_batch_bytes_identical(name, batch):
    side = _same_bytes_and_roundtrip(name, batch)
    if name == "grans":
        assert side["grans_model"][0] == 2


def test_dense_fallback_bytes_identical():
    """96x112 planes: too few lanes to group, so grans writes the dense
    v0 sidecar (the golden dct_grans case)."""
    side = _same_bytes_and_roundtrip("grans", _planes(96, 112, seed=5))
    assert side["grans_model"][0] == 0


def test_rans_uint16_two_passes_identical():
    rng = np.random.default_rng(0)
    arr = (rng.integers(0, 700, size=(40, 24, 3)) ** 1.3).astype(np.uint16)
    _same_bytes_and_roundtrip("rans", arr)


def test_frozen_tables_imported_from_vcf_tpu(frame, batch):
    jc, tc = _pair("grans")
    jc.freeze_tables(frame)
    tc.import_tables(*jc._frozen)
    for arr in (frame, batch):
        pj, sj = jc.encode(arr)
        pt, st = tc.encode(arr)
        assert (pt, st) == (pj, sj)
        assert np.array_equal(tc.decode(pt, st), arr)
    # the port's own training gives the same tables
    tc2 = tentropy.get("grans", device=CPU)
    tc2.freeze_tables(frame)
    for mine, theirs in zip(tc2._frozen, jc._frozen):
        np.testing.assert_array_equal(mine, theirs)
    tc.thaw_tables()
    assert tc._frozen is None


def test_import_tables_validates(frame):
    jc, tc = _pair("grans")
    jc.freeze_tables(frame)
    freqs, cums = jc._frozen
    with pytest.raises(ValueError, match="sum"):
        bad = freqs.copy()
        bad[0, 0] += 1
        tc.import_tables(bad, cums)
    with pytest.raises(ValueError, match="prefix"):
        bad = cums.copy()
        bad[3, 5] += 1
        tc.import_tables(freqs, bad)
    with pytest.raises(ValueError, match=r"\(64, 256\)"):
        tc.import_tables(freqs[:4], cums[:4])


def test_lanes_and_histograms_match_vcf_tpu(batch):
    s_streams = 256
    lanes_j = np.asarray(jrans.subband_lanes(jnp.asarray(batch), 8, s_streams))
    lanes_t = trans.subband_lanes(torch.from_numpy(batch), 8, s_streams)
    np.testing.assert_array_equal(lanes_t.numpy(), lanes_j)
    np.testing.assert_array_equal(
        trans.subband_unlanes(lanes_t, 8, batch.shape).numpy(), batch)
    np.testing.assert_array_equal(
        trans.group_histograms(lanes_t, 64).numpy(),
        np.asarray(jrans.group_histograms(jnp.asarray(lanes_j), 64)))


def test_quantize_freqs_matches_vcf_tpu():
    rng = np.random.default_rng(5)
    for min_all in (False, True):
        counts = rng.integers(0, 50, size=256) * (rng.random(256) < 0.3)
        np.testing.assert_array_equal(
            trans.quantize_freqs(counts, min_all=min_all),
            jrans.quantize_freqs(counts, min_all=min_all))


def test_grans_rejects_corrupt_counts_sidecar(frame):
    tc = tentropy.get("grans", device=CPU)
    payload, side = tc.encode(frame)
    blob = bytearray(side["grans_model"])
    # v2 layout: version, S, L, n_words, ndim, shape, len(counts_z), counts_z
    off = 14 + 4 * 3
    (cz_len,) = np.frombuffer(bytes(blob[off:off + 4]), "<u4")
    counts = np.frombuffer(zlib.decompress(bytes(blob[off + 4:off + 4 + cz_len])),
                           "<u4").copy()
    counts[1] += 1
    counts[2] -= 1
    cz = zlib.compress(counts.astype("<u4").tobytes(), 9)
    bad = bytes(blob[:off]) + np.uint32(len(cz)).tobytes() + cz + \
        bytes(blob[off + 4 + cz_len:])
    with pytest.raises(ValueError, match="counts sidecar"):
        tc.decode(payload, {"grans_model": bad})


def test_registry():
    assert isinstance(tentropy.get("tiff"), tentropy.TIFFCodec)
    assert isinstance(tentropy.get("zlib"), tentropy.ZlibCodec)
    with pytest.raises(ValueError, match="device"):
        tentropy.get("grans")
    assert isinstance(tentropy.get("huffman"), tentropy.HuffmanCodec)
    assert isinstance(tentropy.get("png"), tentropy.PNGCodec)
    # srans (ROADMAP A6) and ihuff (A8), which raised until they were
    # ported, are device codecs: they need a device and return the codec
    for name, cls in (("srans", tentropy.SparseRANSCodec),
                      ("ihuff", tentropy.InterleavedHuffmanCodec)):
        with pytest.raises(ValueError, match="device"):
            tentropy.get(name)
        assert isinstance(tentropy.get(name, device=CPU), cls)
