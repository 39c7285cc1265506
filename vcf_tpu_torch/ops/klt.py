"""2D KLT, a per-image PCA-learned block transform (port of
vcf_tpu/ops/klt.py; torch).

Per channel, the covariance of the image's own BxB blocks -> eigh ->
eigenvectors sorted by descending eigenvalue as transform rows
(src/2D-KLT.py:147-167); forward `X @ W.T`, inverse `Y @ W` (:248, :290);
the weights travel as (3, D, D) float32 side information (`weights`,
:593-601); subband reordering is the DCT stage's (:603-610).

The covariance is one float32 product per channel (full float32 on CUDA:
the `Codec` refuses TF32) and `torch.linalg.eigh` runs on the tensors'
device.  The sign of each eigenvector is fixed: its first largest-|.|
component is made positive.  Eigenvectors of nearly equal eigenvalues
are not unique, so two devices (or this package and vcf_tpu) may train
different weights and write different streams (ROADMAP C3); a stream
decodes the same anywhere, given the weights it carries.
"""

from __future__ import annotations

import numpy as np
import torch

from vcf_tpu_torch.codestream import CodeStream
from vcf_tpu_torch.ops import dct as dct_ops


def channel_blocks(img: torch.Tensor, b: int) -> torch.Tensor:
    """(H, W, C) -> (C, N, b*b) flattened blocks per channel."""
    h, w, c = img.shape
    x = img.reshape(h // b, b, w // b, b, c).permute(4, 0, 2, 1, 3)
    return x.reshape(c, -1, b * b)


def channel_unblocks(blocks: torch.Tensor, h: int, w: int, b: int
                     ) -> torch.Tensor:
    c = blocks.shape[0]
    x = blocks.reshape(c, h // b, w // b, b, b).permute(1, 3, 2, 4, 0)
    return x.reshape(h, w, c)


def train_weights(blocks: torch.Tensor) -> torch.Tensor:
    """(C, N, D) -> (C, D, D) KLT weight matrices (rows = eigenvectors,
    descending eigenvalue, deterministic sign)."""
    centered = blocks - blocks.mean(dim=1, keepdim=True)
    cov = torch.einsum("cnd,cne->cde", centered, centered) / blocks.shape[1]
    _, evecs = torch.linalg.eigh(cov)               # ascending eigenvalues
    w = evecs.flip(-1).transpose(1, 2)              # rows, descending
    idx = torch.argmax(w.abs(), dim=2, keepdim=True)
    sign = torch.sign(torch.gather(w, 2, idx))
    return w * torch.where(sign == 0, torch.ones_like(sign), sign)


def forward(blocks: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(C, N, D), (C, D, D) -> coefficients (C, N, D): X @ W.T"""
    return torch.einsum("cnd,ced->cne", blocks, weights)


def inverse(coeff: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Y @ W (weights orthonormal)."""
    return torch.einsum("cne,ced->cnd", coeff, weights)


# ---------------------------------------------------------------------------
# Pipeline flow (called by vcf_tpu_torch.pipeline.Codec)
# ---------------------------------------------------------------------------

def encode(codec, img: np.ndarray) -> CodeStream:
    cfg = codec.config
    b = cfg.block_size
    soff = codec.spatial_offset

    padded = dct_ops.pad_centered(codec._upload(img).to(torch.float32), b)
    ct = codec._fwd(padded - soff)
    blocks = channel_blocks(ct, b)
    weights = train_weights(blocks)
    h, w = ct.shape[:2]
    coeff_img = channel_unblocks(forward(blocks, weights), h, w, b)
    if cfg.subbands:
        coeff_img = dct_ops.to_subbands(coeff_img, b)

    k, qside = codec._quantize(coeff_img)
    cs = CodeStream()
    codec._store_indexes(cs, k, qside, offset=soff, dtype=np.uint8)
    cs.put_shape(img.shape)
    cs.put_array("weights", weights.cpu().numpy().astype(np.float32))
    return cs


def decode(codec, cs: CodeStream) -> np.ndarray:
    cfg = codec.config
    b = cfg.block_size
    soff = codec.spatial_offset

    shape = cs.get_shape()
    padded_shape = dct_ops.padded_shape(shape, b)
    k, qside = codec._load_indexes(cs, offset=soff, signed=True)
    coeff_img = codec._dequantize(codec._upload(k), qside, padded_shape)
    if cfg.subbands:
        coeff_img = dct_ops.from_subbands(coeff_img, b)
    weights = torch.from_numpy(cs.get_array("weights")).to(codec.device)
    h, w = padded_shape[:2]
    blocks = inverse(channel_blocks(coeff_img, b), weights)
    y = codec._inv(channel_unblocks(blocks, h, w, b)) + soff
    return codec._to_u8(dct_ops.unpad_centered(y, shape))
