"""Temporal (video) codecs (port of vcf_tpu/video): III intra-only and
IPP hybrid coding."""

from vcf_tpu_torch.video.iii import IIICodec
from vcf_tpu_torch.video.ipp import IPPCodec


def get(video_config, codec_config, device):
    if video_config.mode == "iii":
        return IIICodec(video_config, codec_config, device)
    if video_config.mode == "ipp":
        return IPPCodec(video_config, codec_config, device)
    raise ValueError(f"unknown video mode {video_config.mode!r}")


__all__ = ["IIICodec", "IPPCodec", "get"]
