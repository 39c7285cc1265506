"""Clips of a panning camera with a moving foreground block: a frozen
copy of `vcf_tpu_torch.io.test_video` made on the device.

Traffic parameters: `frames` a clip, `pool` distinct clips.  The
background of clip p is a crop of one larger image of its own that moves
by (1, 2) pixels a frame; a 32 x 32 block brightened by 50 - i moves
across it by (3, 1) a frame."""

from __future__ import annotations

import torch

from portbench.inputs import _content


def make(traffic: dict, config: dict, seed: int, device) -> list:
    """The pool of clips, each (frames, H, W, 3) uint8 on `device`."""
    h, w, n = config["height"], config["width"], traffic["frames"]
    gen = _content.generator(seed, device)
    pad = 2 * n + 8
    clips = []
    for _ in range(traffic["pool"]):
        big = _content.test_image(h + pad, w + pad, gen, device).to(
            torch.int16)
        frames = []
        for i in range(n):
            crop = big[i:i + h, 2 * i:2 * i + w].clone()
            y0 = (h // 4 + 3 * i) % (h - 40)
            x0 = (w // 3 + i) % (w - 40)
            crop[y0:y0 + 32, x0:x0 + 32] = torch.clamp(
                crop[y0:y0 + 32, x0:x0 + 32] + 50 - i, 0, 255)
            frames.append(crop.clamp(0, 255).to(torch.uint8))
        clips.append(torch.stack(frames))
    return clips
