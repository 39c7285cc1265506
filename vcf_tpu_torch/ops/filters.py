"""Decode-side denoising filters (port of vcf_tpu/ops/filters.py; torch).

The reference's filter layer:
  * gaussian  cv2.GaussianBlur(img, (s, s), 0)          (src/gaussian_blur.py:56)
  * nlm       cv2.fastNlMeansDenoisingColored          (src/NLM.py:50-53)
  * bm3d      bm3d_rgb(img/255, sigma/255)             (src/BM3D.py:42-54)

as vcf_tpu computes them: a separable Gaussian with reflect borders; NLM
as a loop over the search window's offsets, each a box filter (one
`conv2d`) of the squared difference against the shifted image; BM3D's
two stages (hard threshold, then Wiener) with displacement-sweep block
matching that wraps round the frame edges (`torch.roll`, as vcf_tpu's
`jnp.roll`).

vcf_tpu's BM3D avoids gathers and sorts (N argmin passes, and 289
masked sweeps to build each group and to scatter it back).  Here the
N best displacements of a block are the first N of a stable ascending
sort of its distances, with its own displacement forced first: equal
distances keep the displacement order, which is what N passes of a
first-minimum argmin pick.  The group is an index gather and the
aggregation `ordered_add` over the selected displacements, in the
displacement order of vcf_tpu's sweep: every pixel's sum is taken in
that one order on every device, so the filter is deterministic on CUDA
too.  `bm3d_approx` (superseded in vcf_tpu) is not ported.

Every function takes a (H, W, C) tensor and runs on its device; `get`
returns the host-callable filter of a `CodecConfig` on a named device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from vcf_tpu_torch.ops import color as color_ops
from vcf_tpu_torch.ops import dct as dct_ops

#: BT.601 luma weights of BM3D's block matching
LUMA_WEIGHTS = np.array([0.299, 0.587, 0.114], np.float32)


def gaussian_kernel_1d(size: int, sigma: float = 0.0) -> np.ndarray:
    """cv2.getGaussianKernel semantics: sigma<=0 -> 0.3*((size-1)*0.5-1)+0.8."""
    if sigma <= 0:
        sigma = 0.3 * ((size - 1) * 0.5 - 1) + 0.8
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    k = np.exp(-(x**2) / (2 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def reflect_index(n: int, before: int, after: int, device) -> torch.Tensor:
    """Source indexes of a length-n axis padded by (before, after) in
    numpy's "reflect" mode (the edge not repeated; any pad width)."""
    i = torch.arange(-before, n + after, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def _pad_reflect(x: torch.Tensor, rows, cols) -> torch.Tensor:
    """Reflect-pad the first two axes of x by (before, after) pairs."""
    r = reflect_index(x.shape[0], *rows, x.device)
    c = reflect_index(x.shape[1], *cols, x.device)
    return x[r][:, c]


def gaussian_blur(img: torch.Tensor, size: int) -> torch.Tensor:
    """Separable Gaussian blur with reflect borders."""
    k = torch.from_numpy(gaussian_kernel_1d(size)).to(img.device)
    x = img.to(torch.float32)
    pad = size // 2
    xp = _pad_reflect(x, (pad, pad), (0, 0))
    x = torch.einsum("s,hwcs->hwc", k, xp.unfold(0, size, 1))
    xp = _pad_reflect(x, (0, 0), (pad, pad))
    return torch.einsum("s,hwcs->hwc", k, xp.unfold(1, size, 1))


def nlm(img: torch.Tensor, h: float, template: int = 7, search: int = 21
        ) -> torch.Tensor:
    """Non-local means over the search window: for each offset d, the
    patch distance field is a box filter of the channel-mean squared
    difference between the image and its shifted copy; the weights are
    exp(-dist / h^2)."""
    x = img.to(torch.float32)
    hh, ww, _ = x.shape
    t_rad, s_rad = template // 2, search // 2
    pad = s_rad + t_rad
    xp = _pad_reflect(x, (pad, pad), (pad, pad))
    box = torch.full((1, 1, template, template), 1.0 / (template * template),
                     dtype=torch.float32, device=x.device)
    center_ext = xp[pad - t_rad: pad + hh + t_rad,
                    pad - t_rad: pad + ww + t_rad]
    num = torch.zeros_like(x)
    den = torch.zeros((hh, ww, 1), dtype=torch.float32, device=x.device)
    h2 = h * h
    for dy in range(-s_rad, s_rad + 1):
        for dx in range(-s_rad, s_rad + 1):
            shifted_ext = xp[pad + dy - t_rad: pad + dy + hh + t_rad,
                             pad + dx - t_rad: pad + dx + ww + t_rad]
            diff = torch.mean((shifted_ext - center_ext) ** 2, dim=-1)
            d2 = F.conv2d(diff[None, None], box)[0, 0, :, :, None]
            wgt = torch.exp(-d2 / h2)
            num = num + wgt * xp[pad + dy: pad + dy + hh,
                                 pad + dx: pad + dx + ww]
            den = den + wgt
    return num / den


def displacements(s: int) -> np.ndarray:
    """(D, 2) int64 (dy, dx) of the +-s window: (0, 0) first, then the
    rest in row-major order (vcf_tpu's sweep order)."""
    disps = [(dy, dx) for dy in range(-s, s + 1) for dx in range(-s, s + 1)]
    disps.sort(key=lambda d: (d != (0, 0), d))
    return np.asarray(disps, np.int64)


def block_distances(luma: torch.Tensor, disps: np.ndarray, b: int
                    ) -> torch.Tensor:
    """(h, w) luma -> (D, nby, nbx): per block the sum of squared
    differences against the luma displaced by each d, wrapping round the
    frame edges."""
    h, w = luma.shape
    out = []
    for dy, dx in disps:
        shifted = torch.roll(luma, (-int(dy), -int(dx)), (0, 1))
        out.append(((luma - shifted) ** 2).reshape(
            h // b, b, w // b, b).sum((1, 3)))
    return torch.stack(out)


def select_group(dvol: torch.Tensor, n_group: int) -> torch.Tensor:
    """(D, nby, nbx) distances -> (N, nby, nbx) int64 indexes of the N
    nearest displacements, the block's own (index 0) first: a stable
    ascending sort, whose ties keep the displacement order."""
    dwork = dvol.clone()
    dwork[0] = -1.0
    return torch.sort(dwork, dim=0, stable=True).indices[:n_group]


def ordered_add(acc: torch.Tensor, dst: torch.Tensor, vals: torch.Tensor
                ) -> None:
    """acc[dst[k]] += vals[k] for every k, each destination's values added
    in the order of k: the float result of one sequential loop, on every
    device (an `index_add_` with repeated destinations adds them in any
    order on CUDA).  Pass r adds the r-th value of every destination, so
    no destination repeats within a pass."""
    order = torch.argsort(dst, stable=True)
    d = dst[order]
    first = torch.ones_like(d, dtype=torch.bool)
    first[1:] = d[1:] != d[:-1]
    starts = torch.nonzero(first).squeeze(1)
    rank = torch.arange(d.numel(), device=d.device) - starts[
        torch.cumsum(first.to(torch.int64), 0) - 1]
    by_rank = torch.argsort(rank, stable=True)
    sizes = torch.bincount(rank).cpu().tolist()
    pos = 0
    for n in sizes:
        sel = by_rank[pos:pos + n]
        acc.index_add_(0, d[sel], vals[order[sel]])
        pos += n


def _px(blocks: torch.Tensor, b: int) -> torch.Tensor:
    """(..., nby, nbx) -> (..., nby*b, nbx*b): each block's value on its
    pixels."""
    return blocks.repeat_interleave(b, -2).repeat_interleave(b, -1)


def _bm3d_stage(noisy, guide, sigma, b, n_group, s, step_phases,
                wiener: bool):
    """One BM3D stage: matching and, for the Wiener stage, the shrinkage
    spectrum come from `guide`; the filtered data is `noisy`.  Returns
    the stage estimate (noisy's shape)."""
    dev = noisy.device
    h0, w0, c = noisy.shape
    pady, padx = (-h0) % b, (-w0) % b
    xpad = _pad_reflect(noisy, (0, pady), (0, padx))
    gpad = _pad_reflect(guide, (0, pady), (0, padx))
    h, w, _ = xpad.shape
    nby, nbx = h // b, w // b
    disps = displacements(s)
    disp_t = torch.from_numpy(disps).to(dev)
    thresh = 2.7 * sigma
    sig2 = sigma * sigma
    d1 = torch.from_numpy(dct_ops.dct_matrix(n_group)).to(dev)
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    dc_hw = torch.zeros((b, b), dtype=torch.bool, device=dev)
    dc_hw[0, 0] = True
    dc_hw = dc_hw.repeat(nby, nbx)[..., None]

    # the weighted estimates' sums and the weights' sum, per pixel
    acc = torch.zeros((h * w, c + 1), dtype=torch.float32, device=dev)
    offs = [(i * b // step_phases, j * b // step_phases)
            for i in range(step_phases) for j in range(step_phases)]
    for oy, ox in offs:
        xs = torch.roll(xpad, (-oy, -ox), (0, 1))
        gs = torch.roll(gpad, (-oy, -ox), (0, 1))
        luma = color_ops.fma_rows(gs, LUMA_WEIGHTS[None]).squeeze(-1)
        sel = select_group(block_distances(luma, disps, b), n_group)
        dsel = disp_t[sel]                                  # (N, nby, nbx, 2)
        dy, dx = _px(dsel[..., 0], b), _px(dsel[..., 1], b)  # (N, h, w)
        # member n of a block reads its pixels displaced by its d
        src = torch.remainder(rows + dy, h) * w + torch.remainder(cols + dx, w)
        grp = torch.stack([xs.reshape(-1, c)[i] for i in src])
        coeff3 = torch.einsum("mn,nhwc->mhwc", d1, dct_ops.analyze(grp, b))
        if wiener:
            grp_g = torch.stack([gs.reshape(-1, c)[i] for i in src])
            cg3 = torch.einsum("mn,nhwc->mhwc", d1,
                               dct_ops.analyze(grp_g, b))
            del grp_g
            wsh = cg3 * cg3 / (cg3 * cg3 + sig2)            # Wiener spectrum
            coeff3 = coeff3 * wsh
            # aggregation weight ~ 1 / sum(W^2) per group
            wsum = wsh.reshape(n_group, nby, b, nbx, b, c).sum(
                (0, 2, 4, 5)) ** 2
            wgt = 1.0 / (1e-2 + wsum / (n_group * b * b * c))
            del cg3, wsh
        else:
            keep = coeff3.abs() >= thresh
            # always keep each block's spatial DC in the group-DC layer
            keep[0] |= dc_hw
            coeff3 = torch.where(keep, coeff3, torch.zeros_like(coeff3))
            nret = keep.reshape(n_group, nby, b, nbx, b, c).sum(
                (0, 2, 4, 5)).to(torch.float32)
            wgt = 1.0 / (1.0 + nret)
        del grp
        # inverse 1D transform across the group: d1^T c
        est = dct_ops.synthesize(
            torch.einsum("mn,mhwc->nhwc", d1, coeff3), b)
        del coeff3
        wpx = _px(wgt, b)[..., None]                        # (h, w, 1)
        # member n's estimate lands at its source displaced by its d and
        # shifted back by the phase, added in vcf_tpu's sweep order
        # (displacement index; a displacement is in a block's group once)
        dst = (torch.remainder(rows + dy + oy, h) * w
               + torch.remainder(cols + dx + ox, w))
        order = torch.argsort(_px(sel, b).reshape(-1), stable=True)
        w_src = wpx.reshape(-1, 1)[order % (h * w)]
        ordered_add(acc, dst.reshape(-1)[order], torch.cat(
            [est.reshape(-1, c)[order] * w_src, w_src], dim=1))
        del est, dst, order, w_src

    out = (acc[:, :c] / torch.clamp(acc[:, c:], min=1e-6)).reshape(h, w, c)
    return out[:h0, :w0]


def bm3d(img: torch.Tensor, sigma: float, b: int = 8, n_group: int = 8,
         s: int = 8, step_phases: int = 2, stages: int = 2) -> torch.Tensor:
    """Two-stage BM3D (the `bm3d` package's bm3d_rgb role,
    src/BM3D.py:42-54).

    Stage 1 (hard threshold): for each reference block, the N most
    similar blocks in a (2s+1)^2 window are stacked, 3D-transformed (2D
    block DCT x 1D DCT across the group), hard-thresholded at 2.7*sigma,
    inverted, and every member aggregates back at its source weighted
    1/(1+retained).  Stage 2 (Wiener): matching and the shrinkage
    spectrum come from the stage-1 estimate, W = C1^2/(C1^2 + sigma^2)
    applied to the noisy groups.  `step_phases`^2 shifted block grids
    stand in for the reference's overlapping stride."""
    x = img.to(torch.float32)
    est = _bm3d_stage(x, x, sigma, b, n_group, s, step_phases, wiener=False)
    if stages < 2:
        return est
    return _bm3d_stage(x, est, sigma, b, n_group, s, step_phases,
                       wiener=True)


def get(config, device):
    """The host-callable filter of `config` on `device`: fn(uint8 image)
    -> uint8 image."""
    name = config.filter
    device = torch.device(device)
    if name == "gaussian":
        size = config.filter_size
        fn = lambda x: gaussian_blur(x, size)
    elif name == "nlm":
        h, t, s = config.nlm_h, config.nlm_template, config.nlm_search
        fn = lambda x: nlm(x, h, t, s)
    elif name == "bm3d":
        sigma = config.bm3d_sigma
        fn = lambda x: bm3d(x, sigma)
    else:
        raise ValueError(f"unknown filter {name!r}")

    def run(img: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(img)).to(device)
        out = fn(x)
        return torch.clamp(torch.round(out), 0, 255).to(torch.uint8).cpu().numpy()

    return run
