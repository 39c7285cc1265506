"""The port's video readers and writers (vcf_tpu_torch.io.video) against
vcf_tpu's on the CPU: Y4M files equal byte for byte and readable by either
package, `.npz` arrays equal (the zip members carry timestamps, so not
the bytes), per-frame preview PNGs, header errors, and mp4 through PyAV
where it is installed."""

import os

import numpy as np
import pytest

from vcf_tpu.io import video as jvideo
from vcf_tpu_torch.io import read_image
from vcf_tpu_torch.io import video as tvideo


@pytest.fixture(scope="module")
def frames():
    f = tvideo.test_video(3, 64, 80)
    np.testing.assert_array_equal(f, jvideo.test_video(3, 64, 80))
    return f


def test_write_y4m_bytes_match_vcf_tpu(frames, tmp_path):
    pt, pj = str(tmp_path / "t.y4m"), str(tmp_path / "j.y4m")
    assert tvideo.write_y4m(pt, frames) == jvideo.write_y4m(pj, frames)
    with open(pt, "rb") as ft, open(pj, "rb") as fj:
        data = ft.read()
        assert data == fj.read()
    assert data.startswith(b"YUV4MPEG2 W80 H64 F30:1 Ip A1:1 C444 XRGB\n")
    assert data.count(b"FRAME\n") == 3


@pytest.mark.parametrize("n_frames", [None, 2])
def test_read_y4m_reads_each_others_files(frames, tmp_path, n_frames):
    pt, pj = str(tmp_path / "t.y4m"), str(tmp_path / "j.y4m")
    tvideo.write_y4m(pt, frames)
    jvideo.write_y4m(pj, frames)
    want = frames[:n_frames] if n_frames else frames
    for got in (tvideo.read_y4m(pj, n_frames), jvideo.read_y4m(pt, n_frames),
                tvideo.read_video(pj, n_frames)):
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_frames", [None, 1])
def test_npz_round_trip(frames, tmp_path, n_frames):
    pt, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    assert tvideo.write_video(pt, frames) == os.path.getsize(pt)
    jvideo.write_video(pj, frames)
    want = frames[:n_frames] if n_frames else frames
    for got in (tvideo.read_video(pt, n_frames), tvideo.read_video(pj, n_frames),
                jvideo.read_video(pt, n_frames)):
        np.testing.assert_array_equal(got, want)


def test_write_preview_pngs_decode_to_frames(frames, tmp_path):
    prefix = str(tmp_path / "prev")
    paths = tvideo.write_preview(prefix, frames)
    assert paths[:-1] == [f"{prefix}_{i:04d}.png" for i in range(3)]
    for p, f in zip(paths, frames):
        np.testing.assert_array_equal(read_image(p), f)
    clip = paths[-1]
    assert clip in (prefix + ".mp4", prefix + ".y4m")
    assert paths == jvideo.write_preview(str(tmp_path / "prev"), frames)
    if clip.endswith(".y4m"):
        np.testing.assert_array_equal(tvideo.read_y4m(clip), frames)


@pytest.mark.parametrize("header,match", [
    (b"YUV4MPEG2 H64 F30:1 C444\n", "bad y4m header"),
    (b"YUV4MPEG2 W80 H64 F30:1 C420jpeg\n", "only C444"),
])
def test_y4m_header_errors(tmp_path, header, match):
    p = str(tmp_path / "bad.y4m")
    with open(p, "wb") as f:
        f.write(header + b"FRAME\n" + bytes(64 * 80 * 3))
    with pytest.raises(ValueError, match=match):
        tvideo.read_y4m(p)


def test_y4m_bad_frame_marker(frames, tmp_path):
    p = str(tmp_path / "t.y4m")
    tvideo.write_y4m(p, frames[:1])
    with open(p, "ab") as f:
        f.write(b"FRAMX\n" + bytes(64 * 80 * 3))
    with pytest.raises(ValueError, match="frame marker"):
        tvideo.read_y4m(p)


def test_mp4_round_trip_optional_pyav(frames, tmp_path):
    """mp4 goes through PyAV where it is installed (a lossy container:
    a sanity bound, as vcf_tpu's own test)."""
    pytest.importorskip("av")
    p = str(tmp_path / "clip.mp4")
    tvideo.write_video(p, frames)
    back = tvideo.read_video(p)
    assert back.shape == frames.shape
    err = np.sqrt(np.mean((back.astype(float) - frames.astype(float)) ** 2))
    assert err < 12.0


def test_mp4_without_pyav_raises(frames, tmp_path, monkeypatch):
    """Without PyAV an mp4 path raises and names the containers that
    work."""
    import builtins

    real_import = builtins.__import__

    def no_av(name, *args, **kwargs):
        if name == "av":
            raise ImportError("no av")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_av)
    with pytest.raises(RuntimeError, match="PyAV unavailable"):
        tvideo.write_video(str(tmp_path / "clip.mp4"), frames)
    with pytest.raises(RuntimeError, match="PyAV unavailable"):
        tvideo.read_video(str(tmp_path / "clip.mp4"))
