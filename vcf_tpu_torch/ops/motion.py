"""Block motion estimation and compensation (port of vcf_tpu/ops/motion.py).

Full-search SAD over a +-s window with m x m blocks, the three-step fast
search, and block motion compensation with edge clamping (src/IPP_DCT.py
:225-244, :159-204, :378-395).  Every function takes a leading frame
axis where vcf_tpu used jax.vmap: lumas are (H, W) or (G, H, W), frames
(H, W, C) or (G, H, W, C), motion vectors (nby, nbx, 2) or
(G, nby, nbx, 2) int32 holding (dy, dx).

Precision.  `to_luma` reproduces vcf_tpu's float32 dot bit for bit on
any device (`ops.color.fma_rows`: XLA's CPU dot is a fused multiply-add
chain, exact in float64 for pixel values).  The SADs are
summed in float64, where a block's sum of |a - b| over float32 lumas in
[0, 255] is exact in any order (every nonzero luma is >= 0.114, so a
multiple of 2^-27, and a block's SAD is < 2^18: at most 45 bits), so
the argmin does not depend on the order of the sums.  vcf_tpu sums in
float32 in an order XLA picks; its SADs agree to rtol 1e-5 and its mvs
are equal except at near-ties (ROADMAP C6).
"""

from __future__ import annotations

import numpy as np
import torch

from vcf_tpu_torch.ops.color import fma_rows

#: BT.601 luma weights, as cv2.cvtColor(COLOR_RGB2GRAY) (src/IPP_DCT.py:350)
LUMA_WEIGHTS = np.array([0.299, 0.587, 0.114], np.float32)


def to_luma(frame: torch.Tensor, channel_axis: int = -1) -> torch.Tensor:
    """RGB pixels with integer values in 0..255 (uint8, or float32
    holding integers) -> float32 luma, the channel axis removed."""
    return fma_rows(frame, LUMA_WEIGHTS[None], channel_axis).squeeze(
        channel_axis)


def _displacements(s: int, device=None) -> torch.Tensor:
    """(D, 2) int32 (dy, dx) of the +-s window in row-major order."""
    r = torch.arange(-s, s + 1, dtype=torch.int32, device=device)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([dy, dx], dim=-1).reshape(-1, 2)


def _edge_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """Pad the last two axes by p with the edge values (np.pad 'edge')."""
    h, w = x.shape[-2:]
    rows = torch.arange(-p, h + p, device=x.device).clamp_(0, h - 1)
    cols = torch.arange(-p, w + p, device=x.device).clamp_(0, w - 1)
    return x[..., rows, :][..., cols]


def _block_sum(x: torch.Tensor, m: int) -> torch.Tensor:
    *lead, h, w = x.shape
    return x.reshape(*lead, h // m, m, w // m, m).sum(dim=(-3, -1))


def _check_lumas(ref: torch.Tensor, cur: torch.Tensor, m: int) -> None:
    if ref.shape != cur.shape or cur.dim() not in (2, 3):
        raise ValueError(f"lumas must both be (H, W) or (G, H, W), got "
                         f"{tuple(ref.shape)} and {tuple(cur.shape)}")
    h, w = cur.shape[-2:]
    if h % m or w % m:
        raise ValueError(f"{h}x{w} luma is not a multiple of the block {m}")


def full_search(ref_luma: torch.Tensor, cur_luma: torch.Tensor, m: int,
                s: int):
    """Full-search block ME -> (mv (..., nby, nbx, 2) int32 (dy, dx), sad
    (..., nby, nbx) float32 of the winner).  The reference is edge-padded
    by s; ties go to the first candidate in row-major (dy, dx) order."""
    _check_lumas(ref_luma, cur_luma, m)
    h, w = cur_luma.shape[-2:]
    n = 2 * s + 1
    ref_pad = _edge_pad(ref_luma.to(torch.float64), s)
    cur = cur_luma.to(torch.float64)
    sads = torch.stack([
        _block_sum((cur - ref_pad[..., dy:dy + h, dx:dx + w]).abs(), m)
        for dy in range(n) for dx in range(n)])          # (D, ..., nby, nbx)
    best = torch.argmin(sads, dim=0)                    # first minimum wins
    mv = _displacements(s, cur.device)[best]
    return mv, sads.gather(0, best[None])[0].to(torch.float32)


def _patch_sads(ref_pad: torch.Tensor, cur_blocks: torch.Tensor,
                mv: torch.Tensor, m: int, s: int) -> torch.Tensor:
    """SAD of each block against the ref patch at its own (dy, dx), |d| <=
    s: ref_pad (G, H+2s, W+2s) f64, cur_blocks (G, nby, nbx, m, m) f64,
    mv (G, nby, nbx, 2) -> (G, nby, nbx) f64."""
    g, nby, nbx = mv.shape[:3]
    dev = mv.device
    ar = torch.arange(m, device=dev)
    ys = (torch.arange(nby, device=dev) * m + s)[None, :, None] + mv[..., 0]
    xs = (torch.arange(nbx, device=dev) * m + s)[None, None, :] + mv[..., 1]
    rows = ys[..., None, None] + ar[:, None]            # (G, nby, nbx, m, 1)
    cols = xs[..., None, None] + ar[None, :]            # (G, nby, nbx, 1, m)
    gi = torch.arange(g, device=dev)[:, None, None, None, None]
    return (cur_blocks - ref_pad[gi, rows, cols]).abs().sum(dim=(-2, -1))


def three_step_search(ref_luma: torch.Tensor, cur_luma: torch.Tensor, m: int,
                      s: int):
    """Three-step search (src/IPP_DCT.py:159-204): steps s/2, s/4, ..., 1,
    each taking the best of the 3x3 neighbourhood (clipped to +-s) around
    the current vector; same return as `full_search`."""
    _check_lumas(ref_luma, cur_luma, m)
    single = cur_luma.dim() == 2
    ref = ref_luma[None] if single else ref_luma
    cur = cur_luma[None] if single else cur_luma
    g, h, w = cur.shape
    nby, nbx = h // m, w // m
    dev = cur.device
    ref_pad = _edge_pad(ref.to(torch.float64), s)
    blocks = cur.to(torch.float64).reshape(g, nby, m, nbx, m).transpose(2, 3)
    neigh = _displacements(1, dev).to(torch.int64)                  # (9, 2)
    mv = torch.zeros((g, nby, nbx, 2), dtype=torch.int64, device=dev)
    step = max(s // 2, 1)
    while True:
        cands = (mv[None] + neigh[:, None, None, None, :] * step).clamp(-s, s)
        sads = torch.stack([_patch_sads(ref_pad, blocks, c, m, s)
                            for c in cands])                  # (9, G, nby, nbx)
        best = torch.argmin(sads, dim=0)
        mv = cands.gather(0, best[None, ..., None].expand(1, g, nby, nbx, 2))[0]
        if step == 1:
            break
        step //= 2
    sad = _patch_sads(ref_pad, blocks, mv, m, s).to(torch.float32)
    mv = mv.to(torch.int32)
    return (mv[0], sad[0]) if single else (mv, sad)


def compensate(ref: torch.Tensor, mv: torch.Tensor, m: int,
               pad=64) -> torch.Tensor:
    """Motion-compensate (..., H, W, C) frames with per-block integer mvs
    (..., nby, nbx, 2): block (by, bx) copies the m x m patch at
    (by*m + dy, bx*m + dx) of the reference edge-padded by `pad`, out-of-
    frame samples repeating the edge (src/IPP_DCT.py:378-395).  `pad`
    must be >= every |mv| (vcf_tpu's contract; IPP pads by max(s, 8)), and
    then each sample is ref[clamp(y + dy), clamp(x + dx)], equal to
    vcf_tpu bit for bit.  Past it a patch is held inside the padded
    frame, where vcf_tpu's dynamic_slice first wraps a negative start.
    pad=None pads without bound: the per-pixel clamp for any mv, the law
    of the MC kernel (ops/cuda/mc_kernel.py)."""
    *lead, h, w, c = ref.shape
    nby, nbx = mv.shape[-3:-1]
    dev = ref.device
    ar = torch.arange(m, device=dev)

    def source(base, d, size):
        """(..., nby, nbx, m) source indexes along one axis."""
        start = base + d.to(torch.int64)
        if pad is not None:
            start = start.clamp(-pad, size + pad - m)
        return (start[..., None] + ar).clamp(0, size - 1)

    rows = source(torch.arange(nby, device=dev)[:, None] * m, mv[..., 0], h)
    cols = source(torch.arange(nbx, device=dev) * m, mv[..., 1], w)
    x = ref.reshape(-1, h, w, c)
    rows = rows.reshape(x.shape[0], nby, nbx, m)
    cols = cols.reshape(x.shape[0], nby, nbx, m)
    gi = torch.arange(x.shape[0], device=dev)[:, None, None, None, None]
    patches = x[gi, rows[..., :, None], cols[..., None, :]]
    # (G, nby, nbx, m, m, C) -> (G, nby, m, nbx, m, C) -> (..., H, W, C)
    return patches.permute(0, 1, 3, 2, 4, 5).reshape(*lead, h, w, c)
