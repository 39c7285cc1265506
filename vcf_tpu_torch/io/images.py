"""Image file I/O (host side; port of vcf_tpu/io/images.py).

Capability parity with the reference's read/write layer
(src/entropy_image_coding.py:51-79: cv2.imread file-or-URL + RGB
conversion, imageio write).  Here: imageio-backed read with the
self-contained PNG reader (`vcf_tpu_torch.entropy.png`) where imageio
is missing or refuses the file, RGB channel-last uint8 output; PNGs are
written by that container.  Plus a deterministic synthetic test image
so no network is needed (the reference downloads pajarillo_512x512.png; this
environment has no egress).
"""

from __future__ import annotations

import os

import numpy as np


def read_image(path: str) -> np.ndarray:
    """Read an image file or http(s) URL to (H, W, 3) uint8 RGB.

    URL support mirrors the reference's encode_read_fn
    (src/entropy_image_coding.py:51-65, cv2.imread-or-urllib)."""
    if path.startswith(("http://", "https://")):
        import io as _io
        import urllib.request

        with urllib.request.urlopen(path) as resp:  # host-side fetch
            blob = resp.read()
        try:
            import imageio.v2 as iio

            img = np.asarray(iio.imread(_io.BytesIO(blob)))
        except Exception:
            from vcf_tpu_torch.entropy.png import read_png

            img = read_png(blob)
        return _normalize(img)
    try:
        import imageio.v2 as iio

        img = np.asarray(iio.imread(path))
    except Exception:
        from vcf_tpu_torch.entropy.png import read_png

        with open(path, "rb") as f:
            img = read_png(f.read())
    return _normalize(img)


def _normalize(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.shape[2] == 4:
        img = img[:, :, :3]
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    return img


def write_image(path: str, img: np.ndarray) -> int:
    """Write (H, W[, C]) uint8 to an image file; returns bytes written."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        from vcf_tpu_torch.entropy.png import write_png

        blob = write_png(np.asarray(img, dtype=np.uint8))
        with open(path, "wb") as f:
            f.write(blob)
        return len(blob)
    import imageio.v2 as iio

    iio.imwrite(path, np.asarray(img, dtype=np.uint8))
    return os.path.getsize(path)


def test_image(
    height: int = 512, width: int = 512, seed: int = 7, smooth: bool = True
) -> np.ndarray:
    """Deterministic natural-image-like test input (stand-in for the
    reference's pajarillo_512x512.png, which needs a download).

    A sum of low-frequency gradients, color ramps, and filtered noise —
    compressible like a photo, with enough texture to exercise every
    subband.
    """
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float64)
    y /= height
    x /= width
    base = np.stack(
        [
            128 + 80 * np.sin(2 * np.pi * (1.3 * x + 0.7 * y))
            + 30 * np.cos(2 * np.pi * 3.1 * x * y),
            128 + 70 * np.cos(2 * np.pi * (0.9 * x - 1.1 * y))
            + 25 * np.sin(2 * np.pi * 2.3 * y),
            128 + 60 * np.sin(2 * np.pi * (2.1 * x + 1.7 * y * y)),
        ],
        axis=-1,
    )
    if smooth and min(height, width) >= 5:
        # np.convolve(mode="same") returns max(len, kernel) — only valid
        # when the signal is at least as long as the kernel
        noise = rng.normal(0, 18, size=(height, width, 3))
        # cheap separable smoothing for spatial correlation
        kernel = np.array([1, 4, 6, 4, 1], dtype=np.float64)
        kernel /= kernel.sum()
        for axis in (0, 1):
            noise = np.apply_along_axis(
                lambda m: np.convolve(m, kernel, mode="same"), axis, noise
            )
        base = base + noise * 3.0
    # a few hard edges
    base[height // 4 : height // 2, width // 8 : width // 3, 0] += 60
    base[int(height * 0.6) :, int(width * 0.55) :, 2] += 50
    return np.clip(base, 0, 255).astype(np.uint8)
