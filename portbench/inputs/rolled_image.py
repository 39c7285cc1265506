"""Clips of one still image rolled by seeded offsets per frame.

Traffic parameters: `frames` a clip, `pool` distinct clips.  Each clip
has a base image of its own (`_content.test_image` at the
configuration's height and width) and frame i is that image rolled by a
seeded (dy, dx), so every frame has the same statistics and no two
frames are equal."""

from __future__ import annotations

import torch

from portbench.inputs import _content


def make(traffic: dict, config: dict, seed: int, device) -> list:
    """The pool of clips, each (frames, H, W, 3) uint8 on `device`."""
    h, w, n = config["height"], config["width"], traffic["frames"]
    gen = _content.generator(seed, device)
    clips = []
    for _ in range(traffic["pool"]):
        base = _content.test_image(h, w, gen, device)
        dy = torch.randint(0, h, (n,), generator=gen, device=device).tolist()
        dx = torch.randint(0, w, (n,), generator=gen, device=device).tolist()
        clips.append(torch.stack([torch.roll(base, (a, b), (0, 1))
                                  for a, b in zip(dy, dx)]))
    return clips
