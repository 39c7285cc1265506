"""The port's Codec (vcf_tpu_torch) against vcf_tpu's, end to end.

Tolerances, each with its reason:
* golden fixtures: decoded pixels by sha256 and re-encoded bytes exact —
  at 96x112 the port's float32 transform gives the same deadzone indexes
  as vcf_tpu's on the CPU (0 of 32,256 differ); the Lloyd-Max flow's DCT
  takes vcf_tpu's CPU float order (`analyze_xla`, bit-identical: its
  levels are trained on round(coefficient), where 45 of 32,256
  coefficients sit on a .5 tie that another order tips), and the palette
  VQ draws vcf_tpu's k-means++ numbers (ROADMAP C2);
* transforms: coefficients within 1e-3 absolute (float32 sums of up to
  64 products of magnitude <= 2^11 taken in another order, ~2^11 * 2^-24
  per rounding);
* quantization indexes: the +-1 rule — an index may move by 1 across a
  rounding edge, on at most 0.01% of entries, never by more;
* rmse and bpp agree to 3 decimals.
"""

import ast
import hashlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import vcf_tpu
from vcf_tpu.io import test_image as jax_test_image
from vcf_tpu.ops import color as jcolor
from vcf_tpu.ops import dct as jdct
import vcf_tpu_torch
from vcf_tpu_torch import Codec, CodecConfig, CodeStream, metrics
from vcf_tpu_torch.io import test_image as make_test_image
from vcf_tpu_torch.ops import color as tcolor
from vcf_tpu_torch.ops import dct as tdct
from vcf_tpu_torch.pipeline import check_full_fp32

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden"
GOLDEN_CONFIGS = {
    "dct_grans": CodecConfig(entropy="grans"),
    "dct_default_tiff": CodecConfig(),
    "dct_huffman": CodecConfig(entropy="huffman"),
    "ycocg_cbaac": CodecConfig(spatial="none", color="ycocg", qss=16,
                               entropy="cbaac"),
    "colorvq_zlib": CodecConfig(spatial="none", color="none",
                                quantizer="colorvq", entropy="zlib", seed=1),
    "dct_lloydmax_zlib": CodecConfig(quantizer="lloydmax", qss=32,
                                     entropy="zlib"),
}

MAX_DIFF_SHARE = 1e-4


def _indexes(codec, img):
    """Quantization indexes as each package's Codec computes them."""
    if isinstance(codec, vcf_tpu.Codec):
        x = jdct.pad_centered(jnp.asarray(img, jnp.float32), 8)
        return np.asarray(codec._q(codec._analyze(x)))
    x = tdct.pad_centered(torch.from_numpy(img).to(torch.float32), 8)
    return codec._quantize(codec._analyze(x))[0].numpy()


@pytest.mark.parametrize("name", sorted(GOLDEN_CONFIGS))
def test_golden_decodes_to_stored_sha256(name):
    cs = CodeStream.from_file(str(GOLDEN / f"{name}.vcft"))
    rec = Codec(GOLDEN_CONFIGS[name], device="cpu").decode(cs)
    expected = (GOLDEN / f"{name}.sha256").read_text().strip()
    assert hashlib.sha256(rec.tobytes()).hexdigest() == expected


@pytest.mark.parametrize("name", sorted(GOLDEN_CONFIGS))
def test_golden_reencodes_to_stored_bytes(name):
    img = make_test_image(96, 112, seed=5)
    cs = Codec(GOLDEN_CONFIGS[name], device="cpu").encode(img)
    assert cs.to_bytes() == (GOLDEN / f"{name}.vcft").read_bytes()


@pytest.mark.parametrize("b", [4, 8, 16])
def test_xla_order_dct_bit_identical(b):
    """The DCT of the Lloyd-Max, VQ and no-quantizer flows equals
    vcf_tpu's jitted DCT on the CPU bit for bit, both directions, also
    with leading frame axes; the einsum of the deadzone flow does not."""
    x = np.random.default_rng(b).normal(0, 80, (2, 48, 64, 3)).astype(
        np.float32)
    fwd = np.asarray(jax.jit(lambda a: jdct.analyze(a, b))(jnp.asarray(x[1])))
    inv = np.asarray(jax.jit(lambda a: jdct.synthesize(a, b))(
        jnp.asarray(x[1])))
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(tdct.analyze_xla(xt, b)[1].numpy(), fwd)
    np.testing.assert_array_equal(tdct.synthesize_xla(xt, b)[1].numpy(), inv)
    assert not np.array_equal(tdct.analyze(xt[1], b).numpy(), fwd)


@pytest.mark.parametrize("h,w,seed", [(256, 256, 1), (200, 170, 6)])
def test_grans_codec_matches_vcf_tpu(h, w, seed):
    """Both sizes group their lanes: 256x256 as S=256 lanes of sg=4 per
    subband; 200x170 pads its width to 176 first (S=128, sg=2)."""
    img = make_test_image(h, w, seed=seed)
    jc = vcf_tpu.Codec(vcf_tpu.CodecConfig(entropy="grans"))
    tc = Codec(CodecConfig(entropy="grans"), device="cpu")
    d = np.abs(_indexes(tc, img).astype(np.int64) - _indexes(jc, img))
    assert d.max() <= 1
    assert np.count_nonzero(d) <= MAX_DIFF_SHARE * d.size
    cs_j, cs_t = jc.encode(img), tc.encode(img)
    assert cs_t["grans_model"][0] == 2          # grouped lanes, v2 sidecar
    if not d.any():
        assert cs_t.to_bytes() == cs_j.to_bytes()
    rec_t = tc.decode(CodeStream.from_bytes(cs_t.to_bytes()))
    rec_j = np.asarray(jc.decode(cs_j))
    assert abs(metrics.rmse(img, rec_t) - metrics.rmse(img, rec_j)) < 1e-3
    assert abs(metrics.bpp(cs_t, img.shape)
               - vcf_tpu.metrics.bpp(cs_j, img.shape)) < 1e-3
    # each decodes the other's stream to its own reconstruction family
    assert np.array_equal(tc.decode(cs_j), rec_j)


def test_transforms_match_vcf_tpu():
    rng = np.random.default_rng(0)
    x = rng.uniform(-128, 128, size=(32, 48, 3)).astype(np.float32)
    fwd_j = np.asarray(jdct.to_subbands(
        jdct.analyze(jcolor.ycocg_forward(jnp.asarray(x)), 8), 8))
    xt = torch.from_numpy(x)
    fwd_t = tdct.to_subbands(tdct.analyze(tcolor.ycocg_forward(xt), 8), 8)
    np.testing.assert_allclose(fwd_t.numpy(), fwd_j, rtol=0, atol=1e-3)
    back = tcolor.ycocg_inverse(tdct.synthesize(
        tdct.from_subbands(fwd_t, 8), 8))
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=1e-3)
    img = rng.integers(0, 256, size=(61, 45, 3)).astype(np.float32)
    padded = tdct.pad_centered(torch.from_numpy(img), 8)
    np.testing.assert_array_equal(
        padded.numpy(), np.asarray(jdct.pad_centered(jnp.asarray(img), 8)))
    assert tuple(padded.shape) == jdct.padded_shape(img.shape, 8)
    np.testing.assert_array_equal(
        tdct.unpad_centered(padded, img.shape).numpy(), img)


def test_constants_equal_vcf_tpu():
    np.testing.assert_array_equal(tdct.dct_matrix(8), jdct.dct_matrix(8))
    for name in ("YCOCG_FWD", "YCOCG_INV", "YCRCB_FWD", "YCRCB_INV",
                 "CDCT_FWD", "CDCT_INV"):
        np.testing.assert_array_equal(getattr(tcolor, name),
                                      getattr(jcolor, name))
    for cfg_color in ("ycocg", "ycrcb", "cdct", "none"):
        for quant in ("deadzone", "lloydmax"):
            np.testing.assert_array_equal(tcolor.offsets(cfg_color, quant),
                                          jcolor.offsets(cfg_color, quant))


def test_ycocg_r_lossless():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(0, 256, size=(7, 9, 3)))
    y = tcolor.ycocg_r_forward(x)
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(jcolor.ycocg_r_forward(jnp.asarray(x.numpy()))))
    assert torch.equal(tcolor.ycocg_r_inverse(y), x.to(torch.int32))


def test_test_image_bit_identical():
    for h, w, seed in ((96, 112, 5), (61, 45, 11), (4, 4, 0)):
        np.testing.assert_array_equal(make_test_image(h, w, seed=seed),
                                      jax_test_image(h, w, seed=seed))


def test_entropy_only_flow_bytes_identical():
    img = make_test_image(40, 24, seed=2)
    cfg = dict(spatial="none", color="none", quantizer="none", entropy="tiff")
    cs_t = Codec(CodecConfig(**cfg), device="cpu").encode(img)
    cs_j = vcf_tpu.Codec(vcf_tpu.CodecConfig(**cfg)).encode(img)
    assert cs_t.to_bytes() == cs_j.to_bytes()
    np.testing.assert_array_equal(
        Codec(CodecConfig(**cfg), device="cpu").decode(cs_t), img)


def test_stage_timings_recorded():
    codec = Codec(CodecConfig(entropy="grans"), device="cpu")
    cs = codec.encode(make_test_image(64, 64, seed=1))
    assert set(codec.last_timings.as_dict()) == {
        "device:analyze+quantize", "entropy"}
    codec.decode(cs)
    assert set(codec.last_timings.as_dict()) == {
        "entropy", "device:dequantize+synthesize"}


@pytest.mark.parametrize("kw,item", [
    (dict(spatial="klt"), "A12"),
    (dict(spatial="mdct"), "A12"),
    (dict(spatial="lbt", quantizer="lloydmax"), "A12"),
    (dict(quantizer="colorvq", filter="nlm"), "A13"),
    (dict(filter="gaussian"), "A13"),
    (dict(spatial="dwt", filter="bm3d"), "A13"),
    (dict(spatial="none", entropy="srans"), "A6"),
    (dict(entropy="ihuff"), "A8"),
])
def test_unported_flows_raise(kw, item):
    """The flows of ROADMAP A6, A8, A12 and A13, which raised until they
    were ported: each now builds its flow object, filter and entropy codec
    and round-trips a frame (parity with vcf_tpu: test_torch_transforms,
    test_torch_filters, test_torch_device_entropy)."""
    img = make_test_image(32, 48, seed=3)
    codec = Codec(CodecConfig(**kw), device="cpu")
    if item == "A12":
        assert codec._ext is not None
    if item == "A13":
        assert callable(codec._filter)
    if item in ("A6", "A8"):
        assert type(codec.entropy_codec).__name__ == {
            "A6": "SparseRANSCodec", "A8": "InterleavedHuffmanCodec"}[item]
    cs = codec.encode(img)
    rec = codec.decode(CodeStream.from_bytes(cs.to_bytes()))
    assert rec.shape == img.shape and rec.dtype == np.uint8
    assert metrics.rmse(img, rec) < 40.0


def test_device_is_required():
    with pytest.raises(TypeError):
        Codec(CodecConfig())


def test_full_fp32_is_enforced():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    # cuDNN's TF32 flag is True by default: a CUDA user turns it off too
    torch.backends.cudnn.allow_tf32 = False
    try:
        check_full_fp32()
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="allow_tf32"):
            check_full_fp32()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def test_full_fp32_refuses_cudnn_tf32():
    """ROADMAP rule 3 covers convolutions too (NLM's box filter is a
    cuDNN conv on the card): TF32 in cuDNN is refused."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="cudnn.allow_tf32"):
            check_full_fp32()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def test_import_does_not_load_jax():
    """Importing every module, and running the native coder, Lloyd-Max
    and the palette VQ, loads neither jax nor vcf_tpu."""
    code = ("import sys, vcf_tpu_torch, vcf_tpu_torch.io, "
            "vcf_tpu_torch.video.ipp, vcf_tpu_torch.ops.motion, "
            "vcf_tpu_torch.ops.cuda.sad_kernel, "
            "vcf_tpu_torch.ops.cuda.mc_kernel, vcf_tpu_torch.ops.dwt, "
            "vcf_tpu_torch.entropy.dwt_device, "
            "vcf_tpu_torch.ops.cuda.rans_ctx, vcf_tpu_torch.native, "
            "vcf_tpu_torch.entropy.huffman, vcf_tpu_torch.entropy.cbahc, "
            "vcf_tpu_torch.entropy.cbaac, vcf_tpu_torch.entropy.png, "
            "vcf_tpu_torch.entropy.pnm, vcf_tpu_torch.ops.prng, "
            "vcf_tpu_torch.ops.vq, vcf_tpu_torch.ops.quantize, "
            "vcf_tpu_torch.parallel.mesh, vcf_tpu_torch.ops.klt, "
            "vcf_tpu_torch.ops.mdct, vcf_tpu_torch.ops.lbt, "
            "vcf_tpu_torch.ops.filters, vcf_tpu_torch.entropy.interleaved; "
            "from vcf_tpu_torch import Codec, CodecConfig; "
            "from vcf_tpu_torch.io import test_image; "
            "img = test_image(24, 32, seed=1); "
            "[Codec(CodecConfig(**kw), 'cpu').encode(img) for kw in ("
            "dict(entropy='cbahc', quantizer='lloydmax'), "
            "dict(spatial='none', color='none', quantizer='colorvq', "
            "entropy='huffman'), dict(spatial='lbt', lbt_epochs=2, "
            "entropy='srans', filter='nlm', nlm_search=3), "
            "dict(spatial='mdct', entropy='ihuff', filter='bm3d'), "
            "dict(spatial='klt', filter='gaussian'))]; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'vcf_tpu' not in sys.modules, 'vcf_tpu imported'")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_module_names_jax_or_vcf_tpu():
    pkg = Path(vcf_tpu_torch.__file__).parent
    for path in pkg.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "vcf_tpu"), \
                    f"{path.relative_to(pkg)} imports {name}"


def _code_strings(tree):
    """String constants of a module that are not docstrings."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    first.value, ast.Constant):
                docs.add(id(first.value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_no_file_reads_the_jax_package():
    """The port reads no file under vcf_tpu/: no string in its code names
    a path in that package or the package directory itself (docstrings may
    cite the original's lines), no C/C++/CUDA source includes from it, and
    the native coder is built from the port's own copy of entropy.cpp."""
    import re
    from vcf_tpu_torch import native

    pkg = Path(vcf_tpu_torch.__file__).parent
    word = re.compile(r"\bvcf_tpu[/\\]")
    for path in pkg.rglob("*.py"):
        for text in _code_strings(ast.parse(path.read_text())):
            assert not word.search(text) and text.strip("/") != "vcf_tpu", \
                f"{path.relative_to(pkg)} names a vcf_tpu path: {text!r}"
    sources = [p for ext in ("*.cpp", "*.cu", "*.cuh", "*.h")
               for p in pkg.rglob(ext)]
    assert pkg / "native" / "entropy.cpp" in sources
    for path in sources:
        for line in path.read_text().splitlines():
            if line.lstrip().startswith("#include"):
                assert not word.search(line), f"{path.name}: {line}"
    assert native.SRC.resolve().parent == (pkg / "native").resolve()
    assert native.BUILD_DIR.resolve() == (pkg / "_build").resolve()


def test_chip_smoke_refuses_without_cuda():
    """chip_smoke.py runs only on a card: without one it exits non-zero
    and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run in full")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
