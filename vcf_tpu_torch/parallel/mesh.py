"""Device meshes and the batch codec (port of vcf_tpu/parallel/mesh.py).

vcf_tpu vmaps the per-frame device work over the frame axis and shards
the frames over a `jax.sharding.Mesh` with shard_map.  Here a `Mesh` is a
tuple of torch devices, one per shard (and optionally a process group,
`parallel.dist`).  Without a mesh the frame axis is a tensor batch
dimension on one device and one kernel launch covers the clip; with one,
the batch is padded to a multiple of the mesh size by repeating its last
frame, split into equal shards (`shard_batch`), each shard coded by the
same device work on its own device, one shard after another, and the
planes gathered in frame order and cut to the batch.  A mesh may name one
device more than once: its shards then run one after another there.

Routes, chosen once from the config as vcf_tpu's `_build` chooses them:

* ``use_pallas`` and a linear color (ycocg, ycocg_r -> ycocg, ycrcb,
  cdct) without perceptual scaling: the color-fused kernels
  `fused_cdct_quantize` / `fused_dequantize_cdct` (B3/B4), u8 -> u8;
* ``use_pallas`` otherwise (``color="none"``, perceptual): the color
  transform in torch around `fused_dct_quantize` /
  `fused_dequantize_idct` (B1/B2);
* ``use_pallas=False``: the unfused torch route, the counterpart of
  vcf_tpu's XLA branch;
* the Lloyd-Max quantizer: the per-frame `Codec`'s own torch transform
  and quantizer, frame by frame (vcf_tpu vmaps the same plain XLA
  functions, mesh.py:237-249; no fused kernel quantizes to trained
  levels), so per-frame levels and indexes equal the per-frame `Codec`'s
  bit for bit.  ``shared_levels=True`` trains one level set from the
  batch's raw histogram instead: each shard's sum, psummed over the mesh
  (`dist.allreduce_histogram`), the levels then placed on every shard
  (`dist.replicate`).  The padding frames of a ragged batch are left out
  of the sum, so the levels do not depend on the mesh (vcf_tpu counts
  them).

On a CPU device the kernel routes run the kernels' plain torch versions;
on CUDA they launch the kernels.  The TPU's shape gates (`supports`,
32-row / 128-lane tiles) have no counterpart: the kernels take any
block-multiple frame.  Subband order is applied to the kernels' block
layout outside them, as vcf_tpu does.  The kernels are planar, so each
direction transposes (N, H, W, 3) <-> (N, 3, H, W) with a full copy.

Indexes saturate to [0, 255] on the kernel routes (src/deadzone.py:64)
and wrap through uint8 on the torch route, as on vcf_tpu's two routes
(ROADMAP C4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from vcf_tpu_torch.config import CodecConfig
from vcf_tpu_torch.ops import color as color_ops
from vcf_tpu_torch.ops import dct as dct_ops
from vcf_tpu_torch.ops import quantize as q_ops
from vcf_tpu_torch.ops.cuda import dct_kernel as dk
from vcf_tpu_torch.parallel import dist
from vcf_tpu_torch.pipeline import Codec, check_full_fp32


def _on_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint8 array -> tensor on `device`, keeping numpy's strides: a
    channel-planar (N, H, W, 3) array uploads as it lies, with no
    transposing copy on the host (torch.from_numpy takes any strides
    but negative ones)."""
    return _host_tensor(np.asarray(arr, np.uint8)).to(device)


def _host_tensor(arr: np.ndarray) -> torch.Tensor:
    if any(st < 0 for st in arr.strides):
        arr = arr.copy()
    return torch.from_numpy(arr)


def _resolve(device) -> torch.device:
    """A torch device with its index: "cuda" is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclass(frozen=True)
class Mesh:
    """One torch device per shard, along one named axis, and the process
    group over which the shards' collectives also run (None: this process
    alone).  A device may appear more than once."""

    devices: Tuple[torch.device, ...]
    axis: str = "data"
    group: Optional[object] = None

    def __post_init__(self):
        devices = tuple(_resolve(d) for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devices)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None, device_type: str = "cuda",
              axis: str = "data") -> Mesh:
    """1-D mesh over the first `n_devices` devices of a type (default:
    all).  Raises when fewer exist; the CPU counts as one device."""
    if device_type == "cuda":
        count = torch.cuda.device_count()
    elif device_type == "cpu":
        count = 1
    else:
        raise ValueError(f"unknown device type {device_type!r}")
    n = count if n_devices is None else int(n_devices)
    if not 1 <= n <= count:
        raise RuntimeError(f"make_mesh: {n} {device_type} devices asked "
                           f"for, {count} visible")
    if device_type == "cpu":
        return Mesh((torch.device("cpu"),), axis)
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis)


def shard_batch(arr, mesh: Mesh) -> List[torch.Tensor]:
    """A batch (array or tensor) -> one tensor per mesh device: equal
    chunks of the leading axis, each on its device (numpy's strides
    kept)."""
    if not isinstance(arr, torch.Tensor):
        arr = _host_tensor(np.asarray(arr))
    return dist._split(arr, mesh)


def check_mesh(mesh: Optional[Mesh], device: torch.device) -> None:
    """A codec's mesh must start on the codec's own device, where the
    shards are gathered."""
    if mesh is not None and mesh.devices[0] != _resolve(device):
        raise ValueError(f"the mesh's first device {mesh.devices[0]} is not "
                         f"the codec's device {device}")


def pad_to(batch: np.ndarray, size: int) -> Tuple[np.ndarray, int]:
    """Pad the leading axis up to a multiple of `size` by repeating the
    last entry -> (padded, original length)."""
    n = batch.shape[0]
    n_pad = (-n) % size
    if n_pad:
        batch = np.concatenate([batch, np.repeat(batch[-1:], n_pad, 0)])
    return batch, n


def gather(shards: List[torch.Tensor], device: torch.device) -> torch.Tensor:
    """Shards' outputs concatenated in shard order on `device`."""
    if len(shards) == 1:
        return shards[0]
    return torch.cat([s.to(device) for s in shards])


# the deadzone flow subtracts 128 before the transform and adds it to the
# indexes (src/2D-DCT.py:107-110)
_SOFF = 128


class BatchCodec:
    """Encode/decode of a batch of frames (N, H, W, 3) on one device, or
    sharded over a mesh whose first device is `device`.

    Device work (color transform + block DCT + quantize) runs on each
    shard at once; entropy coding of the gathered index planes is the
    caller's (see `vcf_tpu_torch.video.IIICodec`)."""

    def __init__(self, config: CodecConfig, device, mesh: Mesh = None,
                 shared_levels: bool = False):
        if (config.spatial != "dct"
                or config.quantizer not in ("deadzone", "lloydmax")):
            raise NotImplementedError(
                "BatchCodec supports the dct+deadzone/lloydmax flows; "
                "use vcf_tpu_torch.Codec per frame for other compositions")
        self.config = config
        self.device = torch.device(device)
        check_mesh(mesh, self.device)
        self.mesh = mesh
        if self.device.type == "cuda":
            check_full_fp32()
        #: lloydmax only: train ONE level set from the batch's summed raw
        #: histogram (the reference's one-table-per-source semantics,
        #: src/LloydMax.py:107-112); False trains per-frame levels, equal
        #: to the per-frame `Codec`'s
        self.shared_levels = bool(shared_levels)
        #: side info of the last encode: {"levels": (N, C, L) or (C, L)}
        self.last_qside: dict = {}
        cname = "ycocg" if config.color == "ycocg_r" else config.color
        self._fwd, self._inv = color_ops.get(cname)
        mats = None if config.perceptual else color_ops.MATRICES.get(cname)
        if config.quantizer == "lloydmax":
            self.route = "lloydmax"
            #: the per-frame Codec of each shard's device
            self._stills = {_resolve(d): Codec(config, d)
                            for d in self._mesh().devices}
        elif not config.use_pallas:
            self.route = "torch"
        elif mats is not None:
            self.route = "cdct"
            self._mf, self._mi = dk.static_mat(mats[0]), dk.static_mat(mats[1])
        else:
            self.route = "planes"

    # ------------------------------------------------------------------
    def _encode(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) uint8 on the device -> (N, H, W, 3) uint8 indexes
        in the config's layout."""
        cfg, b, soff = self.config, self.config.block_size, _SOFF
        if self.route == "torch":
            coeff = dct_ops.analyze(self._fwd(x.to(torch.float32) - soff), b)
            if cfg.perceptual:
                coeff = dct_ops.perceptual_scale(coeff, b)
            if cfg.subbands:
                coeff = dct_ops.to_subbands(coeff, b)
            k = q_ops.deadzone_quantize(coeff, cfg.qss)
            return (k + soff).to(torch.uint8)          # wraps, as XLA's cast
        if self.route == "cdct":
            k = dk.fused_cdct_quantize(x.permute(0, 3, 1, 2).contiguous(),
                                       self._mf, b=b, qss=cfg.qss,
                                       offset=soff)
        else:
            ct = self._fwd(x.to(torch.float32) - soff)
            k = dk.fused_dct_quantize(ct.permute(0, 3, 1, 2).contiguous(),
                                      b=b, qss=cfg.qss, offset=soff,
                                      perceptual=cfg.perceptual)
        k = k.permute(0, 2, 3, 1)
        # a pure permutation of stored indexes: commutes with quantization
        return (dct_ops.to_subbands(k, b) if cfg.subbands
                else k.contiguous())

    def _decode(self, k_u8: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) uint8 indexes on the device -> uint8 frames."""
        cfg, b, soff = self.config, self.config.block_size, _SOFF
        if self.route == "torch":
            coeff = q_ops.deadzone_dequantize(k_u8.to(torch.int32) - soff,
                                              cfg.qss)
            if cfg.subbands:
                coeff = dct_ops.from_subbands(coeff, b)
            if cfg.perceptual:
                coeff = dct_ops.perceptual_scale(coeff, b, inverse=True)
            y = self._inv(dct_ops.synthesize(coeff, b)) + soff
            return torch.clamp(torch.round(y), 0, 255).to(torch.uint8)
        if cfg.subbands:
            k_u8 = dct_ops.from_subbands(k_u8, b)
        planes = k_u8.permute(0, 3, 1, 2).contiguous()
        if self.route == "cdct":
            pix = dk.fused_dequantize_cdct(planes, self._mi, b=b, qss=cfg.qss,
                                           offset=soff)
            return pix.permute(0, 2, 3, 1).contiguous()
        ct = dk.fused_dequantize_idct(planes, b=b, qss=cfg.qss, offset=soff,
                                      perceptual=cfg.perceptual)
        y = self._inv(ct.permute(0, 2, 3, 1)) + soff
        return torch.clamp(torch.round(y), 0, 255).to(torch.uint8)

    # ------------------------------------------------------------------
    def _lloydmax_stats(self, x: torch.Tensor):
        """(N, H, W, 3) uint8 -> (coefficients (N, H, W, C), the frames'
        channels as the columns of one (V, N * C) matrix, and its (N * C,
        bins) raw histogram), as the per-frame Codec computes them."""
        cfg, still = self.config, self._stills[x.device]
        coeff = torch.stack([still._analyze(f.to(torch.float32)) for f in x])
        n, c = coeff.shape[0], coeff.shape[-1]
        per_frame = coeff.permute(1, 2, 0, 3).reshape(-1, n * c)
        hist = q_ops.lloydmax_histogram(
            torch.round(per_frame).to(torch.int32), cfg.q_min, cfg.q_max)
        return coeff, per_frame, hist

    def _encode_lloydmax(self, shards: List[torch.Tensor], n: int
                         ) -> List[torch.Tensor]:
        """Shards of (N_s, H, W, 3) uint8 -> their uint8 Lloyd-Max indexes
        (wrapping through uint8 as vcf_tpu's cast, ROADMAP C4); sets
        `last_qside` (the levels of the first `n` frames)."""
        cfg = self.config
        stats = [self._lloydmax_stats(x) for x in shards]
        if self.shared_levels:
            hists = []
            for i, (coeff, _, hist) in enumerate(stats):
                n_s, c = coeff.shape[0], coeff.shape[-1]
                real = min(max(n - i * n_s, 0), n_s)     # padding left out
                hists.append(hist.reshape(n_s, c, -1)[:real].sum(dim=0))
            ghist = dist.allreduce_histogram(hists, self._mesh())
            levels = q_ops.lloydmax_train_from_hist(ghist, cfg.qss, cfg.q_min,
                                                    cfg.q_max)
            placed = dist.replicate(levels, self._mesh())
            ks = [q_ops.lloydmax_quantize(coeff, lv)
                  for (coeff, _, _), lv in zip(stats, placed)]
            self.last_qside = {"levels": levels.cpu().numpy()}
            return [k.to(torch.uint8) for k in ks]
        ks, levels = [], []
        for coeff, per_frame, hist in stats:
            n_s, h, w, c = coeff.shape
            lv = q_ops.lloydmax_train_from_hist(hist, cfg.qss, cfg.q_min,
                                                cfg.q_max)
            k = q_ops.lloydmax_quantize(per_frame, lv)
            ks.append(k.reshape(h, w, n_s, c).permute(2, 0, 1, 3)
                      .to(torch.uint8))
            levels.append(lv.reshape(n_s, c, -1).cpu().numpy())
        self.last_qside = {"levels": np.concatenate(levels)[:n]}
        return ks

    def _decode_lloydmax(self, k_u8: torch.Tensor, lv: torch.Tensor
                         ) -> torch.Tensor:
        """uint8 Lloyd-Max indexes + (N, C, L) or shared (C, L) levels on
        their device -> uint8 frames, frame by frame as the per-frame Codec
        decodes."""
        still = self._stills[k_u8.device]
        out = []
        for i, k in enumerate(k_u8):
            coeff = q_ops.lloydmax_dequantize(k.to(torch.int32),
                                              lv[i] if lv.dim() == 3 else lv)
            y = still._synthesize(coeff)
            out.append(torch.clamp(torch.round(y), 0, 255).to(torch.uint8))
        return torch.stack(out)

    def _mesh(self) -> Mesh:
        return self.mesh if self.mesh is not None else Mesh((self.device,))

    def _shards(self, batch: np.ndarray) -> Tuple[List[torch.Tensor], int]:
        """A uint8 batch -> (one tensor per shard on its device, the
        batch's length before padding)."""
        batch, n = self.pad_batch(np.asarray(batch, np.uint8))
        return shard_batch(batch, self._mesh()), n

    def _to_host(self, shards: List[torch.Tensor], n: int) -> np.ndarray:
        """The shards' outputs -> one array in frame order, cut to n."""
        if len(shards) == 1:
            return shards[0][:n].cpu().numpy()
        return np.concatenate([s.cpu().numpy() for s in shards])[:n]

    def pad_batch(self, frames: np.ndarray) -> Tuple[np.ndarray, int]:
        """Pad the batch dimension up to a multiple of the mesh size by
        repeating the last frame -> (padded, original length)."""
        return pad_to(frames, 1 if self.mesh is None else self.mesh.size)

    def encode_planes(self, frames: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) uint8 -> (N, Hp, Wp, 3) uint8 index planes."""
        b = self.config.block_size
        shards, n = self._shards(frames)
        if shards[0].shape[1] % b or shards[0].shape[2] % b:
            shards = [torch.stack([dct_ops.pad_centered(f, b) for f in x])
                      for x in shards]
        if self.route == "lloydmax":
            return self._to_host(self._encode_lloydmax(shards, n), n)
        return self._to_host([self._encode(x) for x in shards], n)

    def decode_planes(self, planes: np.ndarray, original_hw=None,
                      qside=None) -> np.ndarray:
        """(N, Hp, Wp, 3) uint8 index planes -> (N, H, W, 3) uint8 frames,
        cropped (centered) to `original_hw` when given.  `qside` is the
        Lloyd-Max side info (default: the last encode's), unused by
        deadzone."""
        shards, n = self._shards(planes)
        if self.route == "lloydmax":
            side = qside if qside is not None else self.last_qside
            levels = np.asarray(side["levels"], np.float32)
            if levels.ndim == 2:                  # one shared level set
                lvs = dist.replicate(levels, self._mesh())
            else:
                lvs = shard_batch(self.pad_batch(levels)[0], self._mesh())
            frames = [self._decode_lloydmax(k, lv)
                      for k, lv in zip(shards, lvs)]
        else:
            frames = [self._decode(k) for k in shards]
        if original_hw is not None and tuple(frames[0].shape[1:3]) != tuple(
                original_hw):
            h, w = original_hw
            top = (frames[0].shape[1] - h) // 2
            left = (frames[0].shape[2] - w) // 2
            frames = [f[:, top:top + h, left:left + w].contiguous()
                      for f in frames]
        return self._to_host(frames, n)
