"""Rate/distortion metrics — parity with the reference's RDE tool.

Definitions (reference: src/RDE.py):
  RMSE  = sqrt(mean((original - decoded)^2))            (:40-55)
  BPP   = total_codestream_bytes * 8 / (W * H [* N])    (:100-104)
  J     = R + D = BPP + RMSE                            (:117-118)

Rate counts every codestream segment including side information,
matching RDE's sum over all `/tmp/encoded*` files (:91-99).
"""

from __future__ import annotations

from typing import Union

import numpy as np

from vcf_tpu_torch.codestream import CodeStream


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    return float(np.sqrt(np.mean((a - b) ** 2)))


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    e = rmse(a, b)
    if e == 0:
        return float("inf")
    return float(20.0 * np.log10(peak / e))


def bpp(stream: Union[CodeStream, int], shape) -> float:
    """Bits per pixel.  shape: (H, W[, C]) for stills, or (N, H, W[, C])
    for video — rate is normalized by N*H*W (src/video_coding.py:72)."""
    nbytes = stream.total_bytes if isinstance(stream, CodeStream) else int(stream)
    if len(shape) >= 4 or (len(shape) == 3 and shape[2] not in (1, 3, 4)):
        n_pixels = int(shape[0]) * int(shape[1]) * int(shape[2])  # N*H*W
        if len(shape) == 4:
            n_pixels = int(shape[0]) * int(shape[1]) * int(shape[2])
    else:
        n_pixels = int(shape[0]) * int(shape[1])
    return nbytes * 8.0 / n_pixels


def j_cost(stream, original: np.ndarray, decoded: np.ndarray) -> dict:
    """Full RDE report: {rate_bpp, distortion_rmse, J}."""
    r = bpp(stream, original.shape)
    d = rmse(original, decoded)
    return {"rate_bpp": r, "distortion_rmse": d, "J": r + d}


def video_report(stream, frames: np.ndarray, decoded: np.ndarray) -> dict:
    """Video-level RD report — the intent of the reference's (neutered)
    video bye(): BPP over N*H*W, mean per-frame RMSE, and J = R + D
    (src/video_coding.py:70-155)."""
    n, h, w = frames.shape[:3]
    nbytes = stream.total_bytes if isinstance(stream, CodeStream) else int(stream)
    r = nbytes * 8.0 / (n * h * w)
    per_frame = [rmse(frames[i], decoded[i]) for i in range(n)]
    d = float(np.mean(per_frame))
    return {
        "rate_bpp": r,
        "distortion_rmse": d,
        "J": r + d,
        "per_frame_rmse": per_frame,
        "n_frames": n,
    }
