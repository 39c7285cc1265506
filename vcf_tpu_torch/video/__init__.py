"""Temporal (video) codecs (port of vcf_tpu/video; III intra-only).

IPP hybrid coding waits for ROADMAP A9.
"""

from vcf_tpu_torch.video.iii import IIICodec


def get(video_config, codec_config, device):
    if video_config.mode == "iii":
        return IIICodec(video_config, codec_config, device)
    if video_config.mode == "ipp":
        raise NotImplementedError(
            "the IPP video codec is not ported yet (ROADMAP queue A, item A9)")
    raise ValueError(f"unknown video mode {video_config.mode!r}")


__all__ = ["IIICodec", "get"]
