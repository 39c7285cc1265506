"""III intra-only video codec (port of vcf_tpu/video/iii.py).

Every frame coded independently by the configured still-image codec
(src/III.py).  When the still config matches the batch path (dct +
deadzone or Lloyd-Max), all frames are coded in one device dispatch through
`parallel.BatchCodec`; with a device entropy codec the whole clip's
index planes are then coded in one call (one "clip.*" segment group),
and with a host codec per frame.  Other compositions fall back to
per-frame coding through `Codec`.  The streams are vcf_tpu's: on equal
index planes the bytes are identical.

vcf_tpu's `mesh` argument goes; the port runs on one named device
(multi-device sharding waits for ROADMAP A15).  `shared_levels` passes
through to `BatchCodec` (Lloyd-Max: one level set for the clip); with a
host entropy codec each frame's segment group then carries that one set,
where vcf_tpu's per-frame loop indexes the (C, L) array by frame and
fails past the third frame (ROADMAP C11).
"""

from __future__ import annotations

import numpy as np
import torch

from vcf_tpu_torch.codestream import CodeStream, PAYLOAD
from vcf_tpu_torch.config import CodecConfig, VideoConfig
from vcf_tpu_torch.pipeline import Codec

#: entropy codecs that run on the device: the whole clip's index planes
#: are coded in ONE batched call (a single "clip.*" segment group) instead
#: of a per-frame host loop
BATCHED_ENTROPY = ("rans", "grans", "srans", "cgrans")


class IIICodec:
    def __init__(self, video_config: VideoConfig, codec_config: CodecConfig,
                 device, shared_levels: bool = False):
        self.vcfg = video_config
        self.ccfg = codec_config
        self.device = torch.device(device)
        self.still = Codec(codec_config, self.device)
        self._batch = None
        if (
            codec_config.spatial == "dct"
            and codec_config.quantizer in ("deadzone", "lloydmax")
            and codec_config.filter == "none"
        ):
            from vcf_tpu_torch.parallel.mesh import BatchCodec

            self._batch = BatchCodec(codec_config, self.device,
                                     shared_levels=shared_levels)

    def encode(self, frames: np.ndarray) -> CodeStream:
        frames = np.asarray(frames)[: self.vcfg.n_frames]
        cs = CodeStream()
        n = frames.shape[0]
        batched = (self._batch is not None
                   and self.ccfg.entropy in BATCHED_ENTROPY)
        if self._batch is not None:
            # one device dispatch for the whole clip
            planes = self._batch.encode_planes(frames)
            levels = self._batch.last_qside.get("levels")
            if batched:
                # device entropy: code ALL frames' planes in one call
                payload, side = self.still.entropy_codec.encode(
                    np.ascontiguousarray(planes))
                cs["clip.payload"] = payload
                for name, blob in side.items():
                    cs[f"clip.{name}"] = blob
                if levels is not None:
                    cs.put_array("clip.q_levels", np.asarray(levels))
            else:
                for i in range(n):
                    payload, side = self.still.entropy_codec.encode(planes[i])
                    cs[f"f{i:04d}.payload"] = payload
                    for name, blob in side.items():
                        cs[f"f{i:04d}.{name}"] = blob
                    sub = CodeStream()
                    sub.put_shape(frames.shape[1:])
                    cs[f"f{i:04d}.shape"] = sub["shape"]
                    if levels is not None:
                        # per-frame trained Lloyd-Max levels (reference
                        # law: one table per source, LloydMax.py:107-112)
                        lv = levels[i] if levels.ndim == 3 else levels
                        cs.put_array(f"f{i:04d}.q_levels", np.asarray(lv))
        else:
            for i, frame in enumerate(frames):
                sub = self.still.encode(frame)
                for name, blob in sub.items():
                    cs[f"f{i:04d}.{name}"] = blob
        cs.put_json(PAYLOAD, {
            "mode": "iii", "n_frames": int(n),
            "frame_shape": [int(s) for s in frames.shape[1:]],
            "batched": bool(batched),
        })
        return cs

    def decode(self, cs: CodeStream) -> np.ndarray:
        meta = cs.get_json(PAYLOAD)
        n = meta["n_frames"]
        if meta.get("batched"):
            if self._batch is None:
                raise ValueError(
                    "codestream was encoded with the batched clip path but "
                    "this decoder's config does not support BatchCodec "
                    f"(spatial={self.ccfg.spatial}, quantizer="
                    f"{self.ccfg.quantizer}, filter={self.ccfg.filter})"
                )
            side = {
                name[len("clip."):]: cs[name]
                for name in cs
                if name.startswith("clip.") and name != "clip.payload"
            }
            planes = self.still.entropy_codec.decode(cs["clip.payload"], side)
            h, w = meta["frame_shape"][:2]
            qside = ({"levels": cs.get_array("clip.q_levels")}
                     if "clip.q_levels" in cs else None)
            return self._batch.decode_planes(
                np.asarray(planes), original_hw=(h, w), qside=qside)
        if self._batch is not None:
            planes = []
            levels = []
            for i in range(n):
                prefix = f"f{i:04d}."
                side = {
                    name[len(prefix):]: cs[name]
                    for name in cs
                    if name.startswith(prefix)
                    and name[len(prefix):] not in ("payload", "shape",
                                                   "q_levels")
                }
                planes.append(
                    self.still.entropy_codec.decode(cs[f"{prefix}payload"], side)
                )
                if f"{prefix}q_levels" in cs:
                    levels.append(cs.get_array(f"{prefix}q_levels"))
            h, w = meta["frame_shape"][:2]
            qside = {"levels": np.stack(levels)} if levels else None
            return self._batch.decode_planes(np.stack(planes),
                                             original_hw=(h, w), qside=qside)
        frames = []
        for i in range(n):
            prefix = f"f{i:04d}."
            sub = CodeStream()
            for name in cs:
                if name.startswith(prefix):
                    sub[name[len(prefix):]] = cs[name]
            frames.append(self.still.decode(sub))
        return np.stack(frames)
