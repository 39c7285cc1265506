"""The port's CLI (`python -m vcf_tpu_torch`, vcf_tpu_torch.cli) against
vcf_tpu's on the CPU (`--device cpu`), mirroring tests/test_cli.py on its
64x48 `test_image(seed=2)` and 64x80 clips.

Rules, as the port holds its codecs elsewhere:

* still streams: the file the port writes equals vcf_tpu's byte for byte
  (every sidecar too under --vcf-layout);
* decoding vcf_tpu's file: the same PNG as vcf_tpu's decode, except that
  the inverse transforms' float32 sums run in another order, so a pixel
  may cross a rounding edge: |d| <= 1 on at most MAX_PIXEL_SHARE of the
  pixels (the ±1 rule; the lossless flows are exact);
* video streams: equal to vcf_tpu's, or every segment but the entropy
  payloads equal (motion vectors included) and the payloads' indexes
  within ±1 on at most MAX_INDEX_SHARE (III: the still codec's ±1 index
  rule) or MAX_IPP_SHARE (IPP: ROADMAP C7, a moved index moves the P
  chain after it) of the entries.

vcf_tpu's runs are cached per module, so each of its configurations
compiles once.
"""

import argparse
import filecmp
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vcf_tpu import cli as jcli
from vcf_tpu.cli import main as jmain
from vcf_tpu_torch import cli as tcli
from vcf_tpu_torch.cli import main
from vcf_tpu_torch.codestream import CodeStream
from vcf_tpu_torch.entropy.zlib_codec import ZlibCodec
from vcf_tpu_torch.io import read_image, write_image
from vcf_tpu_torch.io import test_image as make_test_image
from vcf_tpu_torch.io.video import read_y4m, write_y4m
from vcf_tpu_torch.io.video import test_video as make_test_video

REPO = Path(__file__).resolve().parent.parent
MAX_PIXEL_SHARE = 1e-3
MAX_INDEX_SHARE = 1e-4
MAX_IPP_SHARE = 5e-4
CPU = ["--device", "cpu"]

# name -> (encode flags, decode flags), tests/test_cli.py's configurations
STILL = {
    "zlib": (["-c", "z_lib", "-q", "16"],) * 2,
    "tiff": (["-c", "TIFF"],) * 2,
    "grans": (["-c", "grans"],) * 2,
    "dwt": (["-T", "2D-DWT", "-t", "YCoCg", "-a", "deadzone", "-c", "TIFF",
             "-l", "2", "-q", "16"],) * 2,
    "cbaac_tiles": (["-c", "cbaac", "-q", "16", "--tiles", "4"],
                    ["-c", "cbaac", "-q", "16"]),
    "cbahc_tiles": (["-c", "cbahc", "-q", "16", "--tiles", "4"],
                    ["-c", "cbahc", "-q", "16"]),
    "block_search": (["-L", "10", "-c", "z_lib", "-q", "32"],
                     ["-c", "z_lib", "-q", "32"]),
    "filter_only": (["-T", "no_spatial_transform", "-t", "no_color_transform",
                     "-a", "no_quantizer", "-c", "PNG"],
                    ["-T", "no_spatial_transform", "-t", "no_color_transform",
                     "-a", "no_quantizer", "-f", "gaussian_blur", "-s", "5",
                     "-c", "PNG"]),
}
# name -> (frames, flags)
VIDEO = {
    "ipp": (4, ["-N", "4", "-G", "2", "-M", "16", "-S", "4", "-q", "16",
                "-c", "z_lib", "-T", "IPP"]),
    "iii": (3, ["-N", "3", "-G", "3", "-q", "16", "-c", "z_lib", "-T", "III"]),
}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    write_image(str(d / "original.png"), make_test_image(64, 48, seed=2))
    for n in {n for n, _ in VIDEO.values()}:
        write_y4m(str(d / f"clip{n}.y4m"), make_test_video(n, 64, 80))
    return d


@pytest.fixture(scope="module")
def ref(work):
    """vcf_tpu's CLI runs, once each: name -> the paths it wrote."""
    cache = {}

    def run(name):
        if name not in cache:
            png = str(work / "original.png")
            enc, dec = str(work / f"j_{name}"), str(work / f"j_{name}.png")
            if name in STILL:
                enc_args, dec_args = STILL[name]
                assert jmain(["encode", "-o", png, "-e", enc] + enc_args) == 0
                assert jmain(["decode", "-e", enc, "-d", dec] + dec_args) == 0
            else:
                n, args = VIDEO[name]
                dec = str(work / f"j_{name}.y4m")
                clip = str(work / f"clip{n}.y4m")
                assert jmain(["video-encode", "-o", clip, "-e", enc] + args) == 0
                assert jmain(["video-decode", "-e", enc, "-d", dec] + args) == 0
            cache[name] = enc, dec
        return cache[name]

    return run


def _pixel_rule(a: np.ndarray, b: np.ndarray) -> None:
    """The ±1 rule of the inverse transforms on decoded pixels."""
    assert a.shape == b.shape
    d = np.abs(a.astype(np.int64) - b)
    assert d.max() <= 1
    assert np.count_nonzero(d) <= MAX_PIXEL_SHARE * d.size


def _same_files(a: str, b: str) -> bool:
    return filecmp.cmp(a, b, shallow=False)


@pytest.mark.parametrize("name", list(STILL))
def test_still_stream_matches_vcf_tpu(work, ref, name):
    enc_args, _ = STILL[name]
    out = str(work / f"t_{name}")
    assert main(["encode", "-o", str(work / "original.png"), "-e", out]
                + enc_args + CPU) == 0
    assert _same_files(out, ref(name)[0])


@pytest.mark.parametrize("name", list(STILL))
def test_decodes_vcf_tpu_stream(work, ref, name):
    """The port decodes vcf_tpu's file to vcf_tpu's PNG (the ±1 rule for
    the transforms; the PNG-only filter flow exactly, and equal to the
    port's own blur of the original)."""
    _, dec_args = STILL[name]
    enc, dec_j = ref(name)
    dec = str(work / f"t_{name}_of_j.png")
    assert main(["decode", "-e", enc, "-d", dec] + dec_args + CPU) == 0
    rec, rec_j = read_image(dec), read_image(dec_j)
    if name == "filter_only":
        from vcf_tpu_torch.ops import filters
        from vcf_tpu_torch.config import CodecConfig

        np.testing.assert_array_equal(rec, rec_j)
        orig = read_image(str(work / "original.png"))
        assert not np.array_equal(rec, orig)           # the filter ran
        np.testing.assert_array_equal(rec, filters.get(
            CodecConfig(filter="gaussian", filter_size=5), "cpu")(orig))
    else:
        _pixel_rule(rec, rec_j)


@pytest.mark.parametrize("args", [["-c", "z_lib", "-q", "16"],
                                  ["-c", "huffman", "-q", "16"]])
def test_rde_report_matches_vcf_tpu(work, ref, capsys, args):
    """rde's JSON on the same files equals vcf_tpu's; with --vcf-layout
    it sums every sidecar (src/RDE.py:91-99)."""
    png = str(work / "original.png")
    tag = "rde_" + args[1]
    enc, dec = str(work / tag), str(work / f"dec_{tag}.png")
    layout = ["--vcf-layout"] if args[1] == "huffman" else []
    assert main(["encode", "-o", png, "-e", enc] + layout + args + CPU) == 0
    assert main(["decode", "-e", enc, "-d", dec] + args + CPU) == 0
    capsys.readouterr()
    assert main(["rde", "-o", png, "-e", enc, "-d", dec]) == 0
    report = json.loads(capsys.readouterr().out.strip())
    assert jmain(["rde", "-o", png, "-e", enc, "-d", dec]) == 0
    assert report == json.loads(capsys.readouterr().out.strip())
    total = sum(p.stat().st_size for p in work.iterdir()
                if p.name.startswith(tag))
    assert report["rate_bpp"] == pytest.approx(total * 8 / (64 * 48))
    if layout:
        assert total > os.path.getsize(enc)        # sidecars counted


def test_vcf_layout_files_match_vcf_tpu(work):
    """--vcf-layout writes the payload and every sidecar as its own file,
    each equal to vcf_tpu's; the decode reads them back."""
    png = str(work / "original.png")
    args = ["-c", "huffman", "--vcf-layout"]
    tdir, jdir = work / "layout_t", work / "layout_j"
    tdir.mkdir()
    jdir.mkdir()
    assert main(["encode", "-o", png, "-e", str(tdir / "enc")] + args + CPU) == 0
    assert jmain(["encode", "-o", png, "-e", str(jdir / "enc")] + args) == 0
    names = sorted(p.name for p in tdir.iterdir())
    assert names == sorted(p.name for p in jdir.iterdir())
    assert {"enc", "enc_huffman_tree", "enc_shape"} <= set(names)
    for n in names:
        assert _same_files(str(tdir / n), str(jdir / n)), n
    dec = str(work / "layout.png")
    assert main(["decode", "-e", str(jdir / "enc"), "-d", dec,
                 "-c", "huffman"] + CPU) == 0
    assert read_image(dec).shape == (64, 48, 3)


def test_block_size_search_picks_vcf_tpu_bopt(work, ref):
    """-L 5 picks the block size vcf_tpu picks; it rides in the stream,
    so the decode needs no -B."""
    png = str(work / "original.png")
    args = ["-L", "5", "-c", "z_lib", "-q", "16"]
    out = str(work / "t_bopt")
    assert main(["encode", "-o", png, "-e", out] + args + CPU) == 0
    jout = str(work / "j_bopt")
    assert jmain(["encode", "-o", png, "-e", jout] + args) == 0
    bopt = CodeStream.from_file(out).get_json("bopt")["block_size"]
    assert bopt in (2, 4, 8, 16, 32)
    assert _same_files(out, jout)
    dec = str(work / "t_bopt.png")
    assert main(["decode", "-e", out, "-d", dec, "-c", "z_lib", "-q", "16"]
                + CPU) == 0
    rec = read_image(dec)
    err = np.sqrt(np.mean((rec.astype(float) - read_image(png)) ** 2))
    assert err < 10.0


def _hold_video_streams(a: str, b: str, share: float) -> None:
    """Two video streams: equal bytes, or equal segments but for the zlib
    payloads, whose indexes agree within ±1 on at most `share`."""
    if _same_files(a, b):
        return
    sa, sb = CodeStream.from_file(a), CodeStream.from_file(b)
    assert list(sa) == list(sb)
    n_diff = n_all = 0
    for k in sa:
        if not k.endswith(".payload") or k == "payload":
            assert sa[k] == sb[k], k
            continue
        ia = ZlibCodec().decode(sa[k], {}).astype(np.int64)
        ib = ZlibCodec().decode(sb[k], {})
        d = np.abs(ia - ib)
        assert d.max() <= 1, k
        n_diff += np.count_nonzero(d)
        n_all += d.size
    assert n_diff <= share * n_all


@pytest.mark.parametrize("name", list(VIDEO))
def test_video_stream_matches_vcf_tpu(work, ref, name):
    n, args = VIDEO[name]
    clip = str(work / f"clip{n}.y4m")
    enc, dec = str(work / f"t_{name}"), str(work / f"t_{name}.y4m")
    assert main(["video-encode", "-o", clip, "-e", enc] + args + CPU) == 0
    enc_j, dec_j = ref(name)
    _hold_video_streams(enc, enc_j, MAX_IPP_SHARE if name == "ipp"
                        else MAX_INDEX_SHARE)
    assert main(["video-decode", "-e", enc, "-d", dec] + args + CPU) == 0
    rec, orig = read_y4m(dec), read_y4m(clip)
    assert rec.shape == orig.shape
    err = np.sqrt(np.mean((rec.astype(float) - orig.astype(float)) ** 2))
    assert err < 10.0


@pytest.mark.parametrize("name", list(VIDEO))
def test_video_decodes_vcf_tpu_stream(work, ref, name):
    """The port decodes vcf_tpu's video stream to vcf_tpu's frames: IPP
    bit for bit (ROADMAP C7: each package decodes the other's stream
    exactly), III under the ±1 rule of the inverse transforms."""
    n, args = VIDEO[name]
    enc_j, dec_j = ref(name)
    dec = str(work / f"t_{name}_of_j.y4m")
    assert main(["video-decode", "-e", enc_j, "-d", dec] + args + CPU) == 0
    rec, rec_j = read_y4m(dec), read_y4m(dec_j)
    if name == "ipp":
        np.testing.assert_array_equal(rec, rec_j)
    else:
        _pixel_rule(rec, rec_j)


def test_video_decode_preview(work, ref):
    """--preview writes per-frame PNGs and a preview clip (mp4 with PyAV,
    y4m without), the frames of the decode (src/IPP_DCT.py:796-855)."""
    n, args = VIDEO["iii"]
    enc_j, _ = ref("iii")
    dec, prev = str(work / "prev_dec.y4m"), str(work / "prev")
    assert main(["video-decode", "-e", enc_j, "-d", dec, "--preview", prev]
                + args + CPU) == 0
    frames = read_y4m(dec)
    for i in range(n):
        np.testing.assert_array_equal(read_image(f"{prev}_{i:04d}.png"),
                                      frames[i])
    assert os.path.exists(prev + ".mp4") or os.path.exists(prev + ".y4m")


def test_mp4_input_optional_pyav(work, tmp_path):
    """video-encode reads mp4 through PyAV where it is installed."""
    pytest.importorskip("av")
    from vcf_tpu_torch.io.video import write_video

    clip = str(tmp_path / "clip.mp4")
    write_video(clip, make_test_video(3, 64, 80))
    n, args = VIDEO["iii"]
    enc, dec = str(tmp_path / "enc"), str(tmp_path / "dec.y4m")
    assert main(["video-encode", "-o", clip, "-e", enc] + args + CPU) == 0
    assert main(["video-decode", "-e", enc, "-d", dec] + args + CPU) == 0
    assert read_y4m(dec).shape == (3, 64, 80, 3)


def test_unknown_stage_errors(work, tmp_path):
    with pytest.raises(SystemExit):
        main(["encode", "-o", str(work / "original.png"),
              "-e", str(tmp_path / "x"), "-t", "nope"] + CPU)
    assert not (tmp_path / "x").exists()


@pytest.mark.parametrize("argv", [
    [], ["-T", "2D-DWT", "-q", "7", "-f", "bm3d", "--sigma", "12", "-x",
         "-p", "--classes", "15"],
    ["-a", "vq", "-q", "64", "-b", "2", "-c", "cgrans"],
    ["-T", "IPP", "--st", "2D-LBT", "--epochs", "3", "-G", "4"]])
def test_flags_build_vcf_tpu_configs(argv):
    """Every flag letter and default maps to the configs vcf_tpu's CLI
    builds."""
    parsed = []
    for mod in (tcli, jcli):
        p = argparse.ArgumentParser()
        mod.add_stage_flags(p)
        mod.add_video_flags(p)
        parsed.append(p.parse_args(argv))
    at, aj = parsed
    assert vars(at) == vars(aj)
    assert vars(tcli.config_from_args(at)) == vars(jcli.config_from_args(aj))
    assert (vars(tcli.video_config_from_args(at))
            == vars(jcli.video_config_from_args(aj)))


def test_default_device_without_cuda_raises(work, tmp_path, monkeypatch):
    """With no --device the CLI runs on the card; without one it raises
    and writes nothing, never carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "enc"
    for argv in (["encode", "-o", str(work / "original.png"), "-e", str(out)],
                 ["video-encode", "-o", str(work / "clip3.y4m"),
                  "-e", str(out)]):
        with pytest.raises(SystemExit, match="no CUDA card"):
            main(argv)
    assert list(tmp_path.iterdir()) == []


def test_cli_loads_neither_jax_nor_vcf_tpu(work, tmp_path):
    """`python -m vcf_tpu_torch --help` and a full encode/decode load
    neither jax nor vcf_tpu."""
    png, enc = str(work / "original.png"), str(tmp_path / "enc")
    code = (
        "import runpy, sys\n"
        "sys.argv = ['vcf_tpu_torch', '--help']\n"
        "try:\n"
        "    runpy.run_module('vcf_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "from vcf_tpu_torch.cli import main\n"
        f"assert main(['encode', '-o', {png!r}, '-e', {enc!r}, '-c', 'grans',"
        " '--device', 'cpu']) == 0\n"
        f"assert main(['decode', '-e', {enc!r}, '-d', {enc + '.png'!r},"
        " '-c', 'grans', '--device', 'cpu']) == 0\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'vcf_tpu' not in sys.modules, 'vcf_tpu imported'\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "usage: vcf_tpu_torch" in proc.stdout
    assert os.path.exists(enc + ".png")
