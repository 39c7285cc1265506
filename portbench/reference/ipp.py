"""Plain reference of the IPP closed loop (upstream IPP_DCT.py's
composition with the still transform of `transform`).

GOPs of T frames, each GOP on its own: the first frame intra-coded, every
later frame predicted from the reconstruction of the one before it:

    ref_l = luma(ref);  cur_l = luma(cur)
    mv = full search of m x m blocks over +-s (SAD, first minimum in
         row-major (dy, dx) order, the reference edge-extended)
    pred = ref with each block moved by its mv (samples clamped to the
           frame)
    k = forward(clip(cur - pred + 128));  ref = clip(pred + inverse(k) - 128)

The luma is BT.601 (0.299, 0.587, 0.114) in float32 as a fused
multiply-add chain over (R, G, B), worked here in float64 and rounded to
float32 after each step, which is that chain exactly for pixel values.
The SADs are summed in float64, exact in any order for such lumas.

Plain torch only; no import of the code under test.
"""

from __future__ import annotations

import torch

from portbench.reference import transform

LUMA = (0.299, 0.587, 0.114)


def luma(x: torch.Tensor) -> torch.Tensor:
    """(..., 3, H, W) float32 holding integers -> (..., H, W) float32."""
    w = [float(torch.tensor(v, dtype=torch.float32)) for v in LUMA]
    c = x.to(torch.float64)
    acc = (c[..., 0, :, :] * w[0]).to(torch.float32)
    for i in (1, 2):
        acc = (c[..., i, :, :] * w[i] + acc.to(torch.float64)).to(
            torch.float32)
    return acc


def full_search(ref_l: torch.Tensor, cur_l: torch.Tensor, m: int, s: int
                ) -> torch.Tensor:
    """(G, H, W) lumas -> (G, H/m, W/m, 2) int32 (dy, dx)."""
    g, h, w = cur_l.shape
    rows = torch.arange(-s, h + s, device=cur_l.device).clamp(0, h - 1)
    cols = torch.arange(-s, w + s, device=cur_l.device).clamp(0, w - 1)
    pad = ref_l.to(torch.float64)[:, rows][:, :, cols]
    cur = cur_l.to(torch.float64)
    best = torch.full((g, h // m, w // m), float("inf"), dtype=torch.float64,
                      device=cur.device)
    arg = torch.zeros(best.shape, dtype=torch.int64, device=cur.device)
    i = 0
    for dy in range(2 * s + 1):
        for dx in range(2 * s + 1):
            d = (cur - pad[:, dy:dy + h, dx:dx + w]).abs_()
            sad = d.reshape(g, h // m, m, w // m, m).sum(dim=(2, 4))
            better = sad < best
            best = torch.where(better, sad, best)
            arg = torch.where(better, i, arg)
            i += 1
    n = 2 * s + 1
    return torch.stack([arg // n - s, arg % n - s], -1).to(torch.int32)


def compensate(ref: torch.Tensor, mv: torch.Tensor, m: int) -> torch.Tensor:
    """(G, 3, H, W) reference, (G, H/m, W/m, 2) mvs -> prediction: pixel
    (y, x) of block (by, bx) is ref[clamp(y + dy), clamp(x + dx)]."""
    g, c, h, w = ref.shape
    dy = mv[..., 0].repeat_interleave(m, 1).repeat_interleave(m, 2)
    dx = mv[..., 1].repeat_interleave(m, 1).repeat_interleave(m, 2)
    ys = (torch.arange(h, device=ref.device)[:, None] + dy).clamp(0, h - 1)
    xs = (torch.arange(w, device=ref.device)[None, :] + dx).clamp(0, w - 1)
    idx = (ys * w + xs).reshape(g, 1, h * w).expand(g, c, h * w)
    return ref.reshape(g, c, h * w).gather(2, idx).reshape(g, c, h, w)


def _clip(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 255.0)


def _dec(k: torch.Tensor, qss: int, tf32: bool) -> torch.Tensor:
    return transform.inverse(k, qss, tf32=tf32).to(torch.float32)


def encode(gops: torch.Tensor, m: int, s: int, qss: int = 32,
           tf32: bool = False):
    """(G, T, H, W, 3) uint8 -> (indexes (G, T, 3, H, W) uint8 in block
    layout, mvs (G, T-1, H/m, W/m, 2) int32)."""
    frames = gops.permute(0, 1, 4, 2, 3)
    k = transform.forward(frames[:, 0], qss, tf32=tf32)
    ref = _dec(k, qss, tf32)
    ks, mvs = [k], []
    for t in range(1, frames.shape[1]):
        cur = frames[:, t].to(torch.float32)
        mv = full_search(luma(ref), luma(cur), m, s)
        pred = compensate(ref, mv, m)
        k = transform.forward(_clip(cur - pred + 128.0).to(torch.uint8), qss,
                              tf32=tf32)
        ref = _clip(pred + _dec(k, qss, tf32) - 128.0)
        ks.append(k)
        mvs.append(mv)
    return torch.stack(ks, 1), torch.stack(mvs, 1)


def decode(planes: torch.Tensor, mvs: torch.Tensor, m: int, qss: int = 32,
           tf32: bool = False) -> torch.Tensor:
    """Block-layout indexes (G, T, 3, H, W) and mvs -> the reconstruction
    (G, T, 3, H, W) float32 holding integers."""
    ref = _dec(planes[:, 0], qss, tf32)
    recs = [ref]
    for t in range(1, planes.shape[1]):
        pred = compensate(ref, mvs[:, t - 1], m)
        ref = _clip(pred + _dec(planes[:, t], qss, tf32) - 128.0)
        recs.append(ref)
    return torch.stack(recs, 1)
