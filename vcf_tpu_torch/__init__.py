"""vcf_tpu_torch — the PyTorch + CUDA port of vcf_tpu.

The same codec, formats and configuration as `vcf_tpu`, on PyTorch with
hand-written CUDA kernels for the NVIDIA H100 (sm_90a).  `vcf_tpu` stays
the reference; this package imports neither it nor JAX.

Public API:

    from vcf_tpu_torch import CodecConfig, Codec
    codec = Codec(CodecConfig(entropy="grans"), device="cuda")
    stream = codec.encode(img)          # CodeStream (bytes + side info)
    rec    = codec.decode(stream)       # uint8 image

    from vcf_tpu_torch import VideoConfig, video
    clip = video.get(VideoConfig(n_frames=8), CodecConfig(entropy="grans"),
                     device="cuda")      # III: one BatchCodec dispatch

The device is always named by the caller: there is no default GPU and
no silent CPU placement.
"""

from vcf_tpu_torch.config import CodecConfig, VideoConfig
from vcf_tpu_torch.pipeline import Codec
from vcf_tpu_torch.codestream import CodeStream
from vcf_tpu_torch import metrics

__version__ = "0.1.0"

__all__ = ["CodecConfig", "VideoConfig", "Codec", "CodeStream", "metrics",
           "__version__"]
