"""Learned block transform (LBT): a linear autoencoder trained per image
with Adam (port of vcf_tpu/ops/lbt.py; torch).

A learned encoder/decoder pair over flattened BxB blocks (no bias),
trained on loss = MSE + lambda * mean(log var(coefficients)), the
coding-gain regularizer (src/2D-LBT.py:105-128).  The decoder weights
and the block mean are side information (src/2D-LBT.py:130-136), stored
as float32 arrays `weights` and `mean` in the codestream, or with
`lbt_side_info` in an external .npz file (2D-LBT.py:391-398).

Training is full-batch over all blocks of the image, from the DCT basis,
with torch autograd.  The Adam step is optax's `adam` written out in
float32 in optax's order (`adam_step`), not `torch.optim.Adam`, which
rounds in another order.  The step loop reads nothing back, so on CUDA it
queues without a host sync until the weights are used.
`train_step_fn` is vcf_tpu's data-parallel step: each shard of a mesh
(`parallel.Mesh`) takes the gradients of its own blocks, and their sum
over the mesh (`parallel.dist`) feeds one Adam step (ROADMAP C14).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from vcf_tpu_torch.codestream import CodeStream
from vcf_tpu_torch.ops import dct as dct_ops

#: optax.adam's defaults
B1, B2, EPS = 0.9, 0.999, 1e-8


def blocks_of(img: torch.Tensor, b: int) -> torch.Tensor:
    """(H, W, C) -> (N*C, b*b): per-channel flattened blocks."""
    h, w, c = img.shape
    x = img.reshape(h // b, b, w // b, b, c).permute(0, 2, 4, 1, 3)
    return x.reshape(-1, b * b)


def unblocks_of(blocks: torch.Tensor, h: int, w: int, c: int, b: int
                ) -> torch.Tensor:
    x = blocks.reshape(h // b, w // b, c, b, b).permute(0, 3, 1, 4, 2)
    return x.reshape(h, w, c)


def dct_init(b: int) -> np.ndarray:
    """Separable 2D DCT basis as a (b*b, b*b) matrix (kron of 1D bases)."""
    d = dct_ops.dct_matrix(b)
    return np.kron(d, d).astype(np.float32)


def loss_fn(blocks: torch.Tensor, enc: torch.Tensor, dec: torch.Tensor,
            coding_lambda: float) -> torch.Tensor:
    coeff = blocks @ enc.T
    recon = coeff @ dec.T
    loss = torch.mean((recon - blocks) ** 2)
    if coding_lambda:
        var = torch.var(coeff, dim=0, correction=0) + 1e-8
        loss = loss + coding_lambda * torch.mean(torch.log(var))
    return loss


def adam_step(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
              nu: torch.Tensor, t: int, lr: float):
    """optax.adam(lr)'s update of one parameter at step t (1-based), in
    its float32 order: scale_by_adam's moments and bias corrections, then
    scale(-lr) and apply_updates.  -> (p, mu, nu)."""
    mu = (1 - B1) * g + B1 * mu
    nu = (1 - B2) * (g * g) + B2 * nu
    # 1 - decay**count in float32, the decay a float32 as in optax
    c1 = float(np.float32(1) - np.float32(B1) ** np.float32(t))
    c2 = float(np.float32(1) - np.float32(B2) ** np.float32(t))
    mu_hat = mu / c1
    nu_hat = nu / c2
    update = -lr * (mu_hat / (torch.sqrt(nu_hat) + EPS))
    return p + update, mu, nu


def train(blocks: torch.Tensor, enc0: torch.Tensor, dec0: torch.Tensor,
          epochs: int = 200, lr: float = 1e-3, coding_lambda: float = 0.0
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-batch Adam training of the (encoder, decoder) weight matrices
    on (N, D) mean-removed blocks -> (encoder, decoder) after `epochs`
    steps."""
    params = [enc0.detach().clone(), dec0.detach().clone()]
    moments = [(torch.zeros_like(p), torch.zeros_like(p)) for p in params]
    for t in range(1, epochs + 1):
        enc, dec = (p.requires_grad_(True) for p in params)
        grads = torch.autograd.grad(
            loss_fn(blocks, enc, dec, coding_lambda), (enc, dec))
        with torch.no_grad():
            stepped = [adam_step(p.detach(), g, mu, nu, t, lr)
                       for p, g, (mu, nu) in zip(params, grads, moments)]
        params = [s[0] for s in stepped]
        moments = [(s[1], s[2]) for s in stepped]
    return params[0], params[1]


def train_step_fn(lr: float = 1e-3, coding_lambda: float = 1e-2):
    """One data-parallel training step (vcf_tpu's `train_step_fn`).

    Returns (init, step): `init(params) -> state` for params {"enc":
    (D, D), "dec": (D, D)}, and `step(params, state, shard_blocks, mesh)
    -> (params, state, loss)`, where `shard_blocks` holds each shard's
    (N_s, D) blocks on its device.  Each shard runs autograd of the loss
    on its own blocks (the coefficients' variance is that shard's); the
    gradients are summed over the mesh's shards and the loss averaged,
    then each parameter takes one `adam_step`.  The sum is what vcf_tpu's
    step computes: inside its shard_map, `jax.grad` with respect to the
    replicated parameters already returns the psum of the shards'
    gradients, and the `pmean` after it leaves that sum as it is
    (ROADMAP C14).  Params and state live on the mesh's first device."""
    from vcf_tpu_torch.parallel import dist

    def init(params):
        return {"count": 0,
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def step(params, state, shard_blocks, mesh):
        names = ("enc", "dec")
        losses, grads = [], []
        for blocks in shard_blocks:
            local = [params[k].detach().to(blocks.device).requires_grad_(True)
                     for k in names]
            loss = loss_fn(blocks, *local, coding_lambda)
            grads.append(torch.autograd.grad(loss, local))
            losses.append(loss.detach())
        t = state["count"] + 1
        new_params, mu, nu = {}, {}, {}
        with torch.no_grad():
            for i, k in enumerate(names):
                g = dist._psum([gs[i] for gs in grads], mesh)
                new_params[k], mu[k], nu[k] = adam_step(
                    params[k].detach(), g, state["mu"][k], state["nu"][k], t,
                    lr)
            loss = dist._pmean(losses, mesh)
        return new_params, {"count": t, "mu": mu, "nu": nu}, loss

    return init, step


def _side_info_path(path: str) -> str:
    # np.savez appends ".npz" to a name without it
    return path if path.endswith(".npz") else path + ".npz"


# ---------------------------------------------------------------------------
# Pipeline flow (called by vcf_tpu_torch.pipeline.Codec)
# ---------------------------------------------------------------------------

def encode(codec, img: np.ndarray) -> CodeStream:
    cfg = codec.config
    b = cfg.block_size
    soff = codec.spatial_offset

    padded = dct_ops.pad_centered(codec._upload(img).to(torch.float32), b)
    ct = codec._fwd(padded - soff)
    blocks = blocks_of(ct, b)
    mean = blocks.mean(dim=0)
    centered = blocks - mean

    w0 = torch.from_numpy(dct_init(b)).to(codec.device)
    enc_w, dec_w = train(centered, w0, w0.T, epochs=cfg.lbt_epochs,
                         lr=cfg.lbt_lr, coding_lambda=cfg.lbt_lambda)
    h, w, c = ct.shape
    coeff_img = unblocks_of(centered @ enc_w.T, h, w, c, b)
    if cfg.subbands:
        coeff_img = dct_ops.to_subbands(coeff_img, b)

    k, qside = codec._quantize(coeff_img)
    cs = CodeStream()
    codec._store_indexes(cs, k, qside, offset=soff, dtype=np.uint8)
    cs.put_shape(img.shape)
    dec_np = dec_w.cpu().numpy().astype(np.float32)
    mean_np = mean.cpu().numpy().astype(np.float32)
    if cfg.lbt_side_info:
        np.savez(cfg.lbt_side_info, weights=dec_np, mean=mean_np)
    else:
        cs.put_array("weights", dec_np)
        cs.put_array("mean", mean_np)
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
    if cfg.lbt_side_info:
        with np.load(_side_info_path(cfg.lbt_side_info)) as z:
            dec_np, mean_np = z["weights"], z["mean"]
    else:
        dec_np, mean_np = cs.get_array("weights"), cs.get_array("mean")
    dec_w = torch.from_numpy(np.ascontiguousarray(dec_np)).to(codec.device)
    mean = torch.from_numpy(np.ascontiguousarray(mean_np)).to(codec.device)
    h, w = padded_shape[:2]
    blocks = blocks_of(coeff_img, b) @ dec_w.T + mean
    y = codec._inv(unblocks_of(blocks, h, w, 3, b)) + soff
    return codec._to_u8(dct_ops.unpad_centered(y, shape))
