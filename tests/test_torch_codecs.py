"""The port's host entropy codecs (pnm, png, huffman, cbahc, cbaac) and its
native coder against vcf_tpu's.

Entropy coding is exact: on the same array both packages must write the
same payload and sidecar bytes (tolerance 0) and each must decode the
other's stream.  The native coder (`vcf_tpu_torch.native`, the port's
own copy of the C++ source) must give the same bytes as its pure-Python
plain versions kept beside each codec; those are slow, so they run at
<= 64x64.
"""

import builtins

import numpy as np
import pytest

import vcf_tpu.entropy as jentropy
from vcf_tpu.config import CodecConfig as JConfig
import vcf_tpu_torch
import vcf_tpu_torch.entropy as tentropy
from vcf_tpu_torch import native
from vcf_tpu_torch.config import CodecConfig
from vcf_tpu_torch.entropy import cbaac, cbahc, huffman, png
from vcf_tpu_torch.io import images


def _arrays():
    rng = np.random.default_rng(0)
    return {
        "u8_random": rng.integers(0, 256, (37, 41, 3)).astype(np.uint8),
        "u8_peaked": np.minimum(rng.geometric(0.6, (64, 64)), 255)
        .astype(np.uint8),
        "u8_index_plane": (rng.laplace(0, 2, (48, 40, 3)).round() + 128)
        .clip(0, 255).astype(np.uint8),
        "u16_random": rng.integers(0, 65536, (20, 30)).astype(np.uint16),
        "u16_peaked": (rng.geometric(0.3, (50, 40, 3)) + 120)
        .astype(np.uint16),
        "one_pixel": np.full((1, 1), 9, np.uint8),
        "all_equal": np.full((17, 9, 3), 7, np.uint8),
    }


ARRAYS = _arrays()
CODECS = ("pnm", "png", "huffman", "cbahc", "cbaac")
CONTEXT = [(0, 1), (1, 1), (1, 3), (0, 3)]      # (order, tiles)


def _pair(name, order=1, tiles=1):
    kw = dict(context_order=order, context_tiles=tiles)
    return (tentropy.get(name, CodecConfig(**kw)),
            jentropy.get(name, JConfig(**kw)))


@pytest.mark.parametrize("arr", sorted(ARRAYS))
@pytest.mark.parametrize("name", CODECS)
def test_codec_bytes_equal_vcf_tpu(name, arr):
    a = ARRAYS[arr]
    contexts = CONTEXT if name in ("cbahc", "cbaac") else [(1, 1)]
    for order, tiles in contexts:
        tc, jc = _pair(name, order, tiles)
        pt, st = tc.encode(a)
        pj, sj = jc.encode(a)
        assert pt == pj and st == sj, (order, tiles)
        back = tc.decode(pj, sj)
        assert back.dtype == a.dtype
        np.testing.assert_array_equal(back, a)


def test_huffman_modes_cover_rle_u8_u16():
    """All three Huffman sidecar modes occur: u8 chunked (0), u16 (1) and
    the zero-run extension (2)."""
    tc, _ = _pair("huffman")
    modes = {tc.encode(a)[1]["huffman_tree"][0] for a in ARRAYS.values()}
    assert modes == {0, 1, 2}


def test_cbahc_and_cbaac_u16_byte_planes_and_legacy_sidecar():
    a = ARRAYS["u16_peaked"]
    for name in ("cbahc", "cbaac"):
        tc, jc = _pair(name, 1, 3)
        np.testing.assert_array_equal(tc.decode(*jc.encode(a)), a)
    # a pre-tiles CBAHC sidecar (<BBIB> header, unframed streams)
    plane = ARRAYS["u8_peaked"]
    body = native.cbahc_encode(plane.reshape(-1), 1)
    meta = np.array([8, 1], np.uint8).tobytes() + np.uint32(
        len(body)).tobytes() + bytes([2]) + np.array(plane.shape,
                                                     "<u4").tobytes()
    tc, _ = _pair("cbahc")
    np.testing.assert_array_equal(
        tc.decode(body, {"adaptive_huffman_tree": meta}), plane)


# ---------------------------------------------------------------------------
# native coder against its plain versions (small: the mirrors are slow)
# ---------------------------------------------------------------------------

SMALL = {"u8_peaked_32": ARRAYS["u8_peaked"][:32, :32],
         "u8_random_24": ARRAYS["u8_random"][:8, :8].reshape(-1)[:150],
         "one": np.array([5], np.uint8)}


@pytest.mark.parametrize("order", [0, 1, 2])
@pytest.mark.parametrize("arr", sorted(SMALL))
def test_cbahc_native_equals_plain(arr, order):
    data = np.ascontiguousarray(SMALL[arr]).reshape(-1)
    blob = native.cbahc_encode(data, order)
    assert blob == cbahc.py_encode(data, order)
    np.testing.assert_array_equal(cbahc.py_decode(blob, data.size, order),
                                  data)
    np.testing.assert_array_equal(
        native.cbahc_decode(blob, data.size, order), data)


@pytest.mark.parametrize("order", [0, 1, 2])
@pytest.mark.parametrize("arr", sorted(SMALL))
def test_range_coder_native_equals_plain(arr, order):
    data = np.ascontiguousarray(SMALL[arr]).reshape(-1)
    blob = native.rc_encode(data, order)
    assert blob == cbaac.py_rc_encode(data, order)
    np.testing.assert_array_equal(cbaac.py_rc_decode(blob, data.size, order),
                                  data)


def test_range_coder_rescale_native_equals_plain():
    """Past the 16384-count rescale of the adaptive model (order 0)."""
    rng = np.random.default_rng(3)
    data = np.minimum(rng.geometric(0.4, 20000), 255).astype(np.uint8)
    blob = native.rc_encode(data, 0)
    assert blob == cbaac.py_rc_encode(data, 0)
    np.testing.assert_array_equal(native.rc_decode(blob, data.size, 0), data)


@pytest.mark.parametrize("arr", ["u8_peaked", "u8_index_plane", "u16_random",
                                 "all_equal"])
def test_huffman_native_equals_plain(arr):
    a = ARRAYS[arr].reshape(-1)
    is_u8 = a.dtype == np.uint8
    counts = np.bincount(a, minlength=256 if is_u8 else 65536)
    if is_u8:
        np.testing.assert_array_equal(native.hist8(a), counts)
    lengths = huffman.code_lengths_from_counts(
        counts, huffman.MAX_CODE_LEN_U8 if is_u8 else huffman.MAX_CODE_LEN_U16)
    codes = huffman.canonical_codes(lengths)
    if is_u8:
        blob = native.huffman_encode8(a, lengths, 1000)     # several chunks
        assert blob == huffman.pack_chunked(a, codes, lengths, 1000)
        np.testing.assert_array_equal(
            huffman.unpack_chunked(blob, a.size, lengths), a)
        np.testing.assert_array_equal(
            native.huffman_decode8(blob, a.size, lengths), a)
    blob = native.huffman_encode(a, lengths)
    assert blob == huffman.pack_codes(a, codes, lengths)
    np.testing.assert_array_equal(huffman.unpack_codes(blob, a.size, lengths),
                                  a)
    np.testing.assert_array_equal(native.huffman_decode(blob, a.size, lengths),
                                  a)


@pytest.mark.parametrize("arr", ["u8_random", "u8_peaked", "u16_peaked",
                                 "one_pixel"])
def test_png_filters_native_equal_plain(arr):
    a = ARRAYS[arr]
    a3 = a if a.ndim == 3 else a[:, :, None]
    h, w, c = a3.shape
    raw = (a3.astype(">u2").reshape(h, -1).view(np.uint8)
           if a.dtype == np.uint16 else a3.reshape(h, -1))
    raw = np.ascontiguousarray(raw)
    bpp = c * a.dtype.itemsize
    filtered = native.png_filter(raw, bpp)
    assert filtered == png.filter_rows_plain(raw, bpp)
    rows = np.frombuffer(filtered, np.uint8)
    np.testing.assert_array_equal(
        png.unfilter_rows_plain(rows, h, raw.shape[1], bpp), raw)
    np.testing.assert_array_equal(
        native.png_unfilter(rows, h, raw.shape[1], bpp), raw)


def test_native_builds_into_the_port_and_raises_on_failure(monkeypatch,
                                                           tmp_path):
    """The library comes from the port's own source into its _build
    directory; a failed build raises (no codec falls back)."""
    pkg = native.SRC.resolve().parents[1]
    assert pkg.name == "vcf_tpu_torch"
    assert native.load() is native.load()
    assert native.library_path().parent == pkg / "_build"
    bad = tmp_path / "entropy.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build()


# ---------------------------------------------------------------------------
# PNG files through io.images with imageio absent
# ---------------------------------------------------------------------------

def test_png_read_write_without_imageio(monkeypatch, tmp_path):
    real_import = builtins.__import__

    def no_imageio(name, *args, **kwargs):
        if name.split(".")[0] == "imageio":
            raise ImportError("imageio hidden by the test")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_imageio)
    img = images.test_image(21, 34, seed=4)
    path = str(tmp_path / "frame.png")
    n = images.write_image(path, img)
    blob = open(path, "rb").read()
    assert n == len(blob) and blob == png.write_png(img)
    np.testing.assert_array_equal(images.read_image(path), img)
    gray = img[:, :, 1]
    images.write_image(path, gray)
    np.testing.assert_array_equal(images.read_image(path),
                                  np.stack([gray] * 3, axis=-1))
    with pytest.raises(ImportError):
        images.write_image(str(tmp_path / "frame.bmp"), img)


def test_png_files_cross_read_with_vcf_tpu(tmp_path):
    from vcf_tpu.entropy import png as jpng

    img16 = ARRAYS["u16_peaked"]
    assert png.write_png(img16) == jpng.write_png(img16)
    np.testing.assert_array_equal(png.read_png(jpng.write_png(img16)), img16)


def test_registry():
    for name, cls in (("pnm", tentropy.PNMCodec), ("png", tentropy.PNGCodec),
                      ("huffman", tentropy.HuffmanCodec),
                      ("cbahc", tentropy.CBAHCCodec),
                      ("cbaac", tentropy.CBAACCodec)):
        assert isinstance(tentropy.get(name), cls)
    codec = tentropy.get("cbaac", CodecConfig(context_order=2,
                                              context_tiles=4))
    assert (codec.order, codec.tiles) == (2, 4)
    assert vcf_tpu_torch.entropy.get("zlib") is not None
