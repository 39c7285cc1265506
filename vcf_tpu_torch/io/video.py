"""Video I/O (port of vcf_tpu/io/video.py, the synthetic test sequence).

The mp4/Y4M/npz readers and writers wait for ROADMAP A9.
"""

from __future__ import annotations

import numpy as np


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
