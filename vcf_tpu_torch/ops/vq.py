"""Vector quantization by k-means on a torch device (port of
vcf_tpu/ops/vq.py), and its data-parallel trainer over a mesh
(`kmeans_sharded`).

Capability parity with src/VQ.py (spatial block VQ) and src/color-VQ.py
(RGB palette VQ), which use scikit-learn KMeans (k-means++, n_init=1,
unseeded); vcf_tpu fixes a seed so codestreams are reproducible, and the
port draws vcf_tpu's numbers from that seed (`ops.prng`, ROADMAP C2).

* Seeding: k-means++ (D^2 sampling) on a <=16384-point stride
  subsample.  Every draw's Gumbel noise depends only on its key and the
  subsample's size, so all k - 1 draws' noise is made on the host first
  and uploaded once; the seeding loop then runs on the device with no
  readback per centre.
* Lloyd steps: distances ``|x|^2 - 2 x.c + |c|^2`` (one float32 matmul,
  TF32 off), argmin (the first on ties), centroids as sum / count.  The
  sums are taken in float64: integer-valued points (the palette VQ's
  pixels) sum exactly in any order, where vcf_tpu's float32 one-hot
  product is exact only below 2^24.
* Squared norms follow XLA's CPU order for a short row: one float32
  product, then a fused multiply-add per later term, which keeps the
  palette VQ's distances bit-identical to vcf_tpu's on the CPU.

Centroids are energy-sorted with a label remap like the reference
(src/VQ.py:87-100), so label images are stable under centroid
permutation.
"""

from __future__ import annotations

import numpy as np
import torch

from vcf_tpu_torch.ops import prng
from vcf_tpu_torch.ops.dwt import fma32

#: seeding runs on a stride subsample of at most this many points
SEED_POINTS = 16384
KMEANS_ITERS = 25


def sqnorm(x: torch.Tensor) -> torch.Tensor:
    """(N, D) float32 -> (N,) sum of squares as XLA's CPU reduction takes
    a short row: x0 * x0 rounded, then fma(xj, xj, acc) per later column."""
    acc = x[:, 0] * x[:, 0]
    for j in range(1, x.shape[1]):
        col = x[:, j]
        acc = fma32(col, col.to(torch.float64), acc)
    return acc


def _pairwise_sqdist(x: torch.Tensor, c: torch.Tensor,
                     x2: torch.Tensor = None) -> torch.Tensor:
    """(N, D), (K, D) -> (N, K) squared distances via one matmul."""
    if x2 is None:
        x2 = sqnorm(x)
    xc = torch.matmul(x, c.t())
    return (x2[:, None] - 2.0 * xc) + sqnorm(c)[None, :]


def seed_noise(key: np.ndarray, n: int, k: int) -> tuple:
    """(first, noise): the index of the first centre and the (k - 1, n)
    float32 Gumbel noise of the later draws, from vcf_tpu's key chain
    (split before every draw)."""
    key, sub = prng.split(key)
    first = int(prng.randint(sub, (), 0, n))
    noise = np.empty((max(k - 1, 0), n), np.float32)
    for i in range(k - 1):
        key, sub = prng.split(key)
        noise[i] = prng.gumbel(sub, (n,))
    return first, noise


def kmeans_plus_plus_init(key: np.ndarray, x: torch.Tensor,
                          k: int) -> torch.Tensor:
    """k-means++ seeding (D^2 sampling), deterministic by key, on the
    stride subsample."""
    n_full = x.shape[0]
    if n_full > SEED_POINTS:
        x = x[:: -(-n_full // SEED_POINTS)]
    n = x.shape[0]
    first, noise = seed_noise(key, n, k)
    noise = torch.from_numpy(noise).to(x.device)
    centers = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    centers[0] = x[first]
    d2 = ((x - x[first]) ** 2).sum(dim=1)
    for i in range(1, k):
        # the total in float64: exact for integer points, and the same on
        # every device
        total = torch.clamp(d2.to(torch.float64).sum().to(torch.float32),
                            min=1e-30)
        logits = torch.log(torch.clamp(d2 / total, min=1e-30))
        c_new = x[torch.argmax(noise[i - 1] + logits)]
        centers[i] = c_new
        d2 = torch.minimum(d2, ((x - c_new) ** 2).sum(dim=1))
    return centers


def kmeans(key: np.ndarray, x: torch.Tensor, k: int,
           iters: int = KMEANS_ITERS, init_centers=None):
    """Lloyd's k-means.  x: (N, D).  Returns (centroids (K, D) float32,
    energy-sorted ascending, labels (N,) int32)."""
    x = x.to(torch.float32)
    centers = (kmeans_plus_plus_init(key, x, k) if init_centers is None
               else init_centers.to(torch.float32))
    x2 = sqnorm(x)
    x64 = x.to(torch.float64)
    for _ in range(iters):
        assign = torch.argmin(_pairwise_sqdist(x, centers, x2), dim=1)
        mass = torch.bincount(assign, minlength=k).to(torch.float32)
        sums = torch.zeros((k, x.shape[1]), dtype=torch.float64,
                           device=x.device)
        sums.index_add_(0, assign, x64)
        new = sums.to(torch.float32) / torch.clamp(mass, min=1.0)[:, None]
        centers = torch.where(mass[:, None] > 0, new, centers)
    order = torch.argsort(sqnorm(centers), stable=True)
    centers = centers[order]
    labels = torch.argmin(_pairwise_sqdist(x, centers, x2), dim=1)
    return centers, labels.to(torch.int32)


def kmeans_sharded(key: np.ndarray, x, k: int, mesh,
                   iters: int = KMEANS_ITERS):
    """k-means with the points sharded over `mesh` (`parallel.Mesh`): ONE
    codebook trained across the shards (the BASELINE north star; the
    reference trains one per image, src/VQ.py:110-112).

    x: (N, D) points, N divisible by the mesh size; with a process group
    every process passes all N and takes its rank's rows (rank-major), and
    the labels come back whole on every process.  Seeding is
    `kmeans_plus_plus_init` on the strided global subsample vcf_tpu takes
    (the same for every mesh size).  Each Lloyd step computes every
    shard's assignment mass and float64 sums (the unsharded `kmeans`'s
    statistics), psums them over the mesh in shard order (`parallel.dist`)
    and updates the centres with mass; so the centres equal `kmeans`'s
    with the same init up to the float64 sums' order.  Returns numpy
    (centroids (K, D) energy-sorted, labels (N,) int32, init (K, D))."""
    from vcf_tpu_torch.parallel import dist

    x = dist._as_tensor(x).to(torch.float32)
    n = x.shape[0]
    stride = max(1, n // max(8 * k, 1))
    d0 = mesh.devices[0]
    init = kmeans_plus_plus_init(key, x[::stride].to(d0), k)
    shards = dist._split(dist._process_rows(x, mesh), mesh)
    norms = [sqnorm(xs) for xs in shards]
    wide = [xs.to(torch.float64) for xs in shards]
    centers = init
    for _ in range(iters):
        masses, sums = [], []
        for xs, x2, x64, c in zip(shards, norms, wide,
                                  (centers.to(d) for d in mesh.devices)):
            assign = torch.argmin(_pairwise_sqdist(xs, c, x2), dim=1)
            masses.append(torch.bincount(assign, minlength=k).to(
                torch.float32))
            s = torch.zeros((k, xs.shape[1]), dtype=torch.float64,
                            device=xs.device)
            sums.append(s.index_add_(0, assign, x64))
        mass = dist._psum(masses, mesh)
        new = (dist._psum(sums, mesh).to(torch.float32)
               / torch.clamp(mass, min=1.0)[:, None])
        centers = torch.where(mass[:, None] > 0, new, centers)
    centers = centers[torch.argsort(sqnorm(centers), stable=True)]
    labels = torch.cat([
        torch.argmin(_pairwise_sqdist(xs, centers.to(xs.device), x2),
                     dim=1).to(torch.int32).to(d0)
        for xs, x2 in zip(shards, norms)])
    return (centers.cpu().numpy(),
            dist._gather_rows(labels, mesh).cpu().numpy(),
            init.cpu().numpy())


def assign_labels(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid assignment (decode-side helper and re-encode)."""
    return torch.argmin(_pairwise_sqdist(x.to(torch.float32), centers),
                        dim=1).to(torch.int32)


# ---------------------------------------------------------------------------
# Block packing for spatial VQ (src/VQ.py: non-overlapping BSxBSxC blocks)
# ---------------------------------------------------------------------------

def image_to_blocks(img: torch.Tensor, bs: int) -> torch.Tensor:
    """(H, W, C) -> (H//bs * W//bs, bs*bs*C); H, W % bs == 0."""
    h, w, c = img.shape
    x = img.reshape(h // bs, bs, w // bs, bs, c).permute(0, 2, 1, 3, 4)
    return x.reshape(-1, bs * bs * c)


def blocks_to_image(blocks: torch.Tensor, h: int, w: int, bs: int,
                    c: int) -> torch.Tensor:
    x = blocks.reshape(h // bs, w // bs, bs, bs, c).permute(0, 2, 1, 3, 4)
    return x.reshape(h, w, c)
