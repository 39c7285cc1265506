"""The port's `srans` and `ihuff` entropy codecs against vcf_tpu's on the
CPU: the bytes must be identical (both codecs are exact and the port
follows vcf_tpu's format, table training and stream layout), and each
package decodes the other's stream to the input.

Planes: uint8 and uint16 at sparsities 0.5, 0.9 and 0.99, all zero, one
symbol, and sizes that are not a multiple of 8*S.  vcf_tpu decodes the
port's stream only through equal bytes: its jitted decoders compile once
a shape, which this file keeps to a few.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import vcf_tpu
from vcf_tpu.entropy.interleaved import InterleavedHuffmanCodec as JIHuff
from vcf_tpu.entropy.rans import SparseRANSCodec as JSRans
from vcf_tpu.entropy.rans import pack_flags as jax_pack_flags
from vcf_tpu.io import test_image as jax_test_image
from vcf_tpu_torch import Codec, CodecConfig
from vcf_tpu_torch import entropy as tentropy
from vcf_tpu_torch.entropy import interleaved as tinter
from vcf_tpu_torch.entropy import rans as trans

CODECS = {"srans": (JSRans, trans.SparseRANSCodec),
          "ihuff": (JIHuff, tinter.InterleavedHuffmanCodec)}


def _plane(shape, dtype, sparsity, zero=128, seed=0):
    rng = np.random.default_rng(seed)
    hi = 256 if dtype == np.uint8 else 65536
    a = rng.integers(0, hi, shape).astype(dtype)
    a[rng.random(shape) < sparsity] = zero
    return a


PLANES = {
    "u8-0.5": _plane((40, 56, 3), np.uint8, 0.5),
    "u8-0.9": _plane((40, 56, 3), np.uint8, 0.9),
    "u8-0.99": _plane((40, 56, 3), np.uint8, 0.99),
    "u16-0.5": _plane((40, 56, 3), np.uint16, 0.5),
    "u16-0.9": _plane((40, 56, 3), np.uint16, 0.9, zero=0),
    "u16-0.99": _plane((40, 56, 3), np.uint16, 0.99),
    "all-zero": np.zeros((40, 56, 3), np.uint8),
    "one-symbol": np.full((40, 56, 3), 7, np.uint8),
    "ragged-1001": _plane((1001,), np.uint8, 0.9, zero=0),
}


@pytest.mark.parametrize("plane", list(PLANES))
@pytest.mark.parametrize("name", list(CODECS))
def test_bytes_identical_to_vcf_tpu(name, plane):
    arr = PLANES[plane]
    jcodec, tcodec = CODECS[name][0](), CODECS[name][1](device="cpu")
    payload_j, side_j = jcodec.encode(arr)
    payload_t, side_t = tcodec.encode(arr)
    assert payload_t == payload_j
    assert side_t == side_j
    # the streams are equal, so the port decoding vcf_tpu's stream is each
    # package decoding the other's
    back = tcodec.decode(payload_j, side_j)
    assert back.dtype == arr.dtype
    np.testing.assert_array_equal(back, arr)


def test_pack_flags_is_packbits():
    flags = np.random.default_rng(1).random(8 * 37) < 0.3
    got = trans.pack_flags(torch.from_numpy(flags)).numpy()
    np.testing.assert_array_equal(got, np.packbits(flags))
    np.testing.assert_array_equal(
        got, np.asarray(jax_pack_flags(jnp.asarray(flags))))
    np.testing.assert_array_equal(
        trans.unpack_flags(torch.from_numpy(got)).numpy(), flags)


def test_ihuff_streams_and_tables_match_vcf_tpu():
    from vcf_tpu.entropy import interleaved as jinter

    lengths = np.zeros(256, np.uint8)
    lengths[[3, 9, 200, 201]] = [1, 2, 3, 3]
    for a, b in zip(tinter.build_decode_tables(lengths),
                    jinter.build_decode_tables(lengths)):
        np.testing.assert_array_equal(a, b)
    assert tinter.capacity_bytes(77) == jinter.capacity_bytes(77)
    assert tinter.plan_streams(1001, 8) == jinter.plan_streams(1001, 8)
    for n in (100, 5000, 10 ** 6, 10 ** 8):
        assert (tinter.InterleavedHuffmanCodec.pick_streams(n, 4096)
                == jinter.InterleavedHuffmanCodec.pick_streams(n, 4096))


@pytest.mark.parametrize("kw", [dict(entropy="srans"),
                                dict(entropy="ihuff")])
def test_codec_stream_bytes_identical_to_vcf_tpu(kw):
    """On this frame the two packages' index planes are equal (the DCT's
    +-1 knife edge, ROADMAP C1, moves none of its 6,720 indexes), so the
    whole stream must be."""
    img = jax_test_image(40, 56, seed=2)
    cs_t = Codec(CodecConfig(**kw), device="cpu").encode(img)
    cs_j = vcf_tpu.Codec(vcf_tpu.CodecConfig(**kw)).encode(img)
    assert cs_t.to_bytes() == cs_j.to_bytes()


def test_registry_returns_device_codecs():
    for name, cls in (("srans", trans.SparseRANSCodec),
                      ("ihuff", tinter.InterleavedHuffmanCodec)):
        codec = tentropy.get(name, device="cpu")
        assert isinstance(codec, cls) and codec.device == torch.device("cpu")
        with pytest.raises(ValueError, match="device"):
            tentropy.get(name)
