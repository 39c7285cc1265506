"""Video I/O, host side (port of vcf_tpu/io/video.py).

Containers:

* mp4 through PyAV when the `av` package is importable (optional; the
  reference demuxes with it, src/III.py:74-80, src/IPP_DCT.py:634-644);
* Y4M (YUV4MPEG2) C444, one byte a sample: RGB planes stored under the
  YUV tags, marked by the header flag XRGB (lossless);
* `.npz`, one `frames` array;
* a deterministic synthetic test sequence (a translating and evolving
  pattern) standing in for the reference's default clip
  (src/video_coding.py:23): CIF geometry by default, no file needed.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np


def read_video(path: str, n_frames: Optional[int] = None) -> np.ndarray:
    """Read a video file to (N, H, W, 3) uint8 RGB."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npz":
        with np.load(path) as z:
            frames = z["frames"]
        return frames[:n_frames] if n_frames else frames
    if ext == ".y4m":
        return read_y4m(path, n_frames)
    try:
        import av  # optional
    except ImportError as e:
        raise RuntimeError(
            f"cannot read {path}: PyAV unavailable; use .y4m or .npz"
        ) from e
    frames = []
    with av.open(path) as container:
        for frame in container.decode(video=0):
            frames.append(frame.to_ndarray(format="rgb24"))
            if n_frames and len(frames) >= n_frames:
                break
    return np.stack(frames)


def write_video(path: str, frames: np.ndarray, fps: int = 30) -> int:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npz":
        np.savez(path, frames=np.asarray(frames, dtype=np.uint8))
        return os.path.getsize(path)
    if ext == ".y4m":
        return write_y4m(path, frames, fps)
    try:
        import av
    except ImportError as e:
        raise RuntimeError(
            f"cannot write {path}: PyAV unavailable; use .y4m or .npz"
        ) from e
    with av.open(path, "w") as container:
        stream = container.add_stream("libx264", rate=fps)
        stream.height, stream.width = frames.shape[1:3]
        stream.pix_fmt = "yuv420p"
        for f in frames:
            for packet in stream.encode(av.VideoFrame.from_ndarray(f, format="rgb24")):
                container.mux(packet)
        for packet in stream.encode():
            container.mux(packet)
    return os.path.getsize(path)


def write_preview(prefix: str, frames: np.ndarray, fps: int = 30) -> list:
    """Decode-side convenience outputs, parity with
    src/IPP_DCT.py:796-855: per-frame PNGs `{prefix}_NNNN.png` plus one
    preview video `{prefix}.mp4` (libx264 via PyAV when importable;
    falls back to a lossless `{prefix}.y4m` otherwise).  Returns the
    list of paths written."""
    from vcf_tpu_torch.io.images import write_image

    frames = np.clip(np.asarray(frames), 0, 255).astype(np.uint8)
    paths = []
    for i, frame in enumerate(frames):
        p = f"{prefix}_{i:04d}.png"
        write_image(p, frame)
        paths.append(p)
    try:
        import av  # noqa: F401

        p = f"{prefix}.mp4"
        write_video(p, frames, fps)
    except ImportError:
        p = f"{prefix}.y4m"
        write_y4m(p, frames, fps)
    paths.append(p)
    return paths


# ---------------------------------------------------------------------------
# Y4M (C444, one byte per sample; we store RGB planes under the YUV tags,
# which round-trips losslessly — header flag XRGB marks the convention)
# ---------------------------------------------------------------------------

def write_y4m(path: str, frames: np.ndarray, fps: int = 30) -> int:
    frames = np.asarray(frames, dtype=np.uint8)
    n, h, w, c = frames.shape
    header = f"YUV4MPEG2 W{w} H{h} F{fps}:1 Ip A1:1 C444 XRGB\n".encode()
    with open(path, "wb") as f:
        f.write(header)
        for fr in frames:
            f.write(b"FRAME\n")
            f.write(np.ascontiguousarray(fr.transpose(2, 0, 1)).tobytes())
    return os.path.getsize(path)


def read_y4m(path: str, n_frames: Optional[int] = None) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().decode()
        m_w = re.search(r"W(\d+)", header)
        m_h = re.search(r"H(\d+)", header)
        if not (m_w and m_h):
            raise ValueError("bad y4m header")
        w, h = int(m_w.group(1)), int(m_h.group(1))
        if "C444" not in header:
            raise ValueError("only C444 y4m supported")
        frames = []
        frame_bytes = w * h * 3
        while True:
            line = f.readline()
            if not line:
                break
            if not line.startswith(b"FRAME"):
                raise ValueError("bad y4m frame marker")
            raw = f.read(frame_bytes)
            if len(raw) < frame_bytes:
                break
            planes = np.frombuffer(raw, np.uint8).reshape(3, h, w)
            frames.append(planes.transpose(1, 2, 0))
            if n_frames and len(frames) >= n_frames:
                break
    return np.stack(frames)


# ---------------------------------------------------------------------------
# Synthetic test sequence
# ---------------------------------------------------------------------------

def test_video(
    n_frames: int = 20, height: int = 288, width: int = 352, seed: int = 7
) -> np.ndarray:
    """Deterministic CIF-like sequence: a textured background translating
    by ~1-2 px/frame (exercises motion search) plus a slowly evolving
    foreground block (exercises residual coding)."""
    from vcf_tpu_torch.io.images import test_image

    pad = 2 * n_frames + 8
    big = test_image(height + pad, width + pad, seed=seed).astype(np.int16)
    frames = np.empty((n_frames, height, width, 3), np.uint8)
    for i in range(n_frames):
        dy, dx = i, 2 * i
        crop = big[dy : dy + height, dx : dx + width].copy()
        # moving foreground square
        y0 = (height // 4 + 3 * i) % (height - 40)
        x0 = (width // 3 + i) % (width - 40)
        crop[y0 : y0 + 32, x0 : x0 + 32] = np.clip(
            crop[y0 : y0 + 32, x0 : x0 + 32] + 50 - i, 0, 255
        )
        frames[i] = np.clip(crop, 0, 255).astype(np.uint8)
    return frames
