"""Command-line interface with VCF flag parity (port of vcf_tpu/cli.py).

One entry point selects the whole composition explicitly:

    python -m vcf_tpu_torch encode -o in.png -e encoded [stage flags]
    python -m vcf_tpu_torch decode -e encoded -d out.png [stage flags]
    python -m vcf_tpu_torch rde    -o in.png -e encoded -d out.png
    python -m vcf_tpu_torch video-encode / video-decode ... (-T III|IPP)

Flag letters match the reference where they exist (SURVEY §5 "Config /
flag system"): -T transform head, -t color transform, -a quantizer,
-f filter, -c entropy codec, -q QSS/clusters, -B block size, -l DWT
levels, -w wavelet, -m/-n Lloyd-Max support, -s filter size,
-p perceptual, -x disable subbands, -L lambda (RD block-size search),
-N frames, -G GOP, -M ME block, -S search range, -R RDO lambda,
--order context order, --epochs/--lr for the learned transform.
VCF stage names (2D-DCT, YCoCg, deadzone, no_filter, TIFF, ...) are
accepted as aliases.

Every subcommand that builds a codec runs it on `--device`, the CUDA
card by default (`--device cpu` for the CPU).  Without a card the
default refuses to start: nothing falls back to the CPU.  On a card the
CLI, which owns its process, turns TF32 off in matmuls and in cuDNN
before it builds a codec, since the codecs refuse CUDA otherwise.
Streams and files are those of vcf_tpu's CLI, byte for byte where the
quantization indexes agree.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import Optional

import numpy as np
import torch

from vcf_tpu_torch.config import CodecConfig, VideoConfig

# VCF module-name aliases -> config values
SPATIAL_ALIASES = {
    "2d-dct": "dct", "dct": "dct",
    "2d-dwt": "dwt", "dwt": "dwt",
    "2d-klt": "klt", "klt": "klt",
    "2d-mdct": "mdct", "mdct": "mdct",
    "2d-lbt": "lbt", "lbt": "lbt",
    "no_spatial_transform": "none", "none": "none",
}
COLOR_ALIASES = {
    "ycocg": "ycocg", "ycocg_r": "ycocg_r", "ycrcb": "ycrcb",
    "color-dct": "cdct", "cdct": "cdct",
    "no_color_transform": "none", "none": "none",
}
QUANT_ALIASES = {
    "deadzone": "deadzone", "lloydmax": "lloydmax",
    "vq": "vq", "color-vq": "colorvq", "colorvq": "colorvq",
    "no_quantizer": "none", "none": "none",
}
FILTER_ALIASES = {
    "no_filter": "none", "none": "none",
    "gaussian_blur": "gaussian", "gaussian": "gaussian",
    "nlm": "nlm", "bm3d": "bm3d",
}
ENTROPY_ALIASES = {
    "tiff": "tiff", "png": "png", "pnm": "pnm",
    "z_lib": "zlib", "zlib": "zlib",
    "huffman": "huffman", "ihuff": "ihuff", "rans": "rans", "srans": "srans",
    "grans": "grans", "cgrans": "cgrans",
    "cbahc": "cbahc", "cbaac": "cbaac",
}


def _alias(table, value, what):
    key = value.lower()
    if key not in table:
        raise SystemExit(f"unknown {what} {value!r}; choose from {sorted(set(table))}")
    return table[key]


def add_stage_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("-T", "--transform", default="2D-DCT",
                   help="spatial transform / video head (default: 2D-DCT)")
    p.add_argument("-t", "--color_transform", default="YCoCg")
    p.add_argument("-a", "--quantizer", default="deadzone")
    p.add_argument("-f", "--filter", default="no_filter")
    p.add_argument("-c", "--entropy_image_codec", default="TIFF")
    p.add_argument("-q", "--QSS", type=int, default=32,
                   help="quantization step / cluster count (stage-dependent)")
    p.add_argument("-B", "--block_size_DCT", type=int, default=8)
    p.add_argument("-l", "--levels", type=int, default=5)
    p.add_argument("-w", "--wavelet", default="db5")
    p.add_argument("-m", "--min_val", type=int, default=-2048)
    p.add_argument("-n", "--max_val", type=int, default=2047)
    p.add_argument("-s", "--filter_size", type=int, default=5)
    p.add_argument("-H", "--nlm_h", type=float, default=10.0)
    p.add_argument("--nlm_template", type=int, default=7)
    p.add_argument("--nlm_search", type=int, default=21)
    p.add_argument("--sigma", type=float, default=25.0,
                   help="BM3D sigma (reference: BM3D.py -s)")
    p.add_argument("-p", "--perceptual_quantization", action="store_true")
    p.add_argument("-x", "--disable_subbands", action="store_true")
    p.add_argument("-L", "--Lambda", type=float, default=None,
                   help="RD-optimize the DCT block size over 2..128 "
                        "(J = bytes + Lambda*RMSE, src/2D-DCT.py:533-579)")
    p.add_argument("--order", type=int, default=1)
    p.add_argument("--classes", type=int, default=4,
                   help="cgrans context classes: 4 (speed) or 15 "
                        "(rate priority, ~-19%% vs order-0)")
    p.add_argument("--tiles", type=int, default=1,
                   help="independent per-tile adaptive streams for "
                        "CBAAC/CBAHC (>1 trades a few %% rate for "
                        "parallel host encode/decode; docs/FORMATS.md)")
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--side_info", default="",
                   help="external file for trained LBT weights "
                        "(2D-LBT.py:39,48); default: inside the stream")
    p.add_argument("-b", "--block_size_VQ", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-g", "--debug", action="store_true")


def add_video_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("-N", "--n_frames", type=int, default=20)
    p.add_argument("-G", "--GOP", type=int, default=10)
    p.add_argument("-M", "--ME_block", type=int, default=16)
    p.add_argument("-S", "--search_range", type=int, default=8)
    p.add_argument("-R", "--RDO_lambda", type=float, default=0.0)
    p.add_argument("--st", default="2D-DCT",
                   help="spatial transform inside the video codec "
                        "(reference: IPP_DCT.py --st)")
    p.add_argument("--fast_search", action="store_true")


def config_from_args(args) -> CodecConfig:
    quant = _alias(QUANT_ALIASES, args.quantizer, "quantizer")
    head = args.transform
    if head.lower().split("_")[0] in ("iii", "ipp"):
        # video head: the inner spatial stage comes from --st
        head = getattr(args, "st", "2D-DCT")
    return CodecConfig(
        spatial=_alias(SPATIAL_ALIASES, head, "spatial transform"),
        color=_alias(COLOR_ALIASES, args.color_transform, "color transform"),
        quantizer=quant,
        filter=_alias(FILTER_ALIASES, args.filter, "filter"),
        entropy=_alias(ENTROPY_ALIASES, args.entropy_image_codec, "entropy codec"),
        block_size=args.block_size_DCT,
        subbands=not args.disable_subbands,
        perceptual=args.perceptual_quantization,
        dwt_levels=args.levels,
        wavelet=args.wavelet,
        lbt_epochs=args.epochs,
        lbt_lr=args.lr,
        lbt_side_info=getattr(args, "side_info", ""),
        qss=args.QSS if quant in ("deadzone", "lloydmax") else 32,
        q_min=args.min_val,
        q_max=args.max_val,
        vq_block_size=args.block_size_VQ,
        vq_clusters=args.QSS if quant == "vq" else 256,
        colorvq_clusters=args.QSS if quant == "colorvq" else 32,
        filter_size=args.filter_size,
        nlm_h=args.nlm_h,
        nlm_template=args.nlm_template,
        nlm_search=args.nlm_search,
        bm3d_sigma=args.sigma,
        context_order=args.order,
        context_tiles=args.tiles,
        context_classes=args.classes,
        seed=args.seed,
    )


def video_config_from_args(args) -> VideoConfig:
    mode = "ipp" if args.transform.lower().startswith("ipp") else "iii"
    return VideoConfig(
        mode=mode,
        n_frames=args.n_frames,
        gop_size=args.GOP,
        me_block=args.ME_block,
        search_range=args.search_range,
        fast_search=args.fast_search,
        rdo_lambda=args.RDO_lambda,
    )


def add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device the codec runs on (default: cuda; "
                        "cpu runs the plain versions of the kernels)")


def resolve_device(name: str) -> torch.device:
    """The codec device of `--device`: a CUDA device only where a card is
    visible (then with TF32 off in matmuls and cuDNN, as the codecs
    require), else a clear error; never a silent move to the CPU."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(
                f"--device {name}: no CUDA card is visible; pass "
                "--device cpu to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    return device


def optimize_block_size(img: np.ndarray, config: CodecConfig, lam: float,
                        device) -> int:
    """RD search over block sizes 2^1..2^7: J = compressed_bytes +
    lambda * RMSE (reference: src/2D-DCT.py:533-579)."""
    from vcf_tpu_torch.pipeline import Codec
    from vcf_tpu_torch import metrics

    best_b, best_j = config.block_size, float("inf")
    for b in [2 ** i for i in range(1, 8)]:
        if b > min(img.shape[0], img.shape[1]):
            break
        cfg = config.replace(block_size=b)
        codec = Codec(cfg, device)
        cs = codec.encode(img)
        rec = codec.decode(cs)
        j = cs.total_bytes + lam * metrics.rmse(img, rec)
        logging.debug("J=%s for block_size=%s", j, b)
        if j < best_j:
            best_j, best_b = j, b
    return best_b


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="vcf_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = parser.add_subparsers(dest="command", required=True)

    pe = sub.add_parser("encode", help="encode a still image")
    pe.add_argument("-o", "--original", default="/tmp/original.png")
    pe.add_argument("-e", "--encoded", default="/tmp/encoded")
    pe.add_argument("--vcf-layout", action="store_true",
                    help="write payload+sidecars as separate files like VCF")
    add_stage_flags(pe)
    add_device_flag(pe)

    pd = sub.add_parser("decode", help="decode a still image")
    pd.add_argument("-e", "--encoded", default="/tmp/encoded")
    pd.add_argument("-d", "--decoded", default="/tmp/decoded.png")
    add_stage_flags(pd)
    add_device_flag(pd)

    pr = sub.add_parser("rde", help="rate/distortion report (VCF RDE.py)")
    pr.add_argument("-o", "--original", default="/tmp/original.png")
    pr.add_argument("-e", "--encoded", default="/tmp/encoded")
    pr.add_argument("-d", "--decoded", default="/tmp/decoded.png")

    pve = sub.add_parser("video-encode", help="encode a video (III/IPP)")
    pve.add_argument("-o", "--original", required=True,
                     help="input video (.y4m/.npz, mp4 with PyAV)")
    pve.add_argument("-e", "--encoded", default="/tmp/encoded_video")
    add_stage_flags(pve)
    add_video_flags(pve)
    add_device_flag(pve)

    pvd = sub.add_parser("video-decode", help="decode a video")
    pvd.add_argument("-e", "--encoded", default="/tmp/encoded_video")
    pvd.add_argument("-d", "--decoded", required=True,
                     help="output video (.y4m/.npz)")
    pvd.add_argument("--preview", default="",
                     help="also emit per-frame PNGs {prefix}_NNNN.png and "
                          "an mp4 preview {prefix}.mp4 (y4m when PyAV is "
                          "absent), parity with IPP_DCT.py:796-855")
    add_stage_flags(pvd)
    add_video_flags(pvd)
    add_device_flag(pvd)

    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if getattr(args, "debug", False) else logging.INFO,
        format="%(levelname)s %(message)s",
    )
    device = resolve_device(args.device) if hasattr(args, "device") else None

    if args.command == "encode":
        from vcf_tpu_torch.io import read_image
        from vcf_tpu_torch.pipeline import Codec

        img = read_image(args.original)
        config = config_from_args(args)
        bopt = None
        if args.Lambda is not None and config.spatial == "dct":
            bopt = optimize_block_size(img, config, args.Lambda, device)
            logging.info("optimal block_size=%s", bopt)
            config = config.replace(block_size=bopt)
        cs = Codec(config, device).encode(img)
        if bopt is not None:
            # record the chosen block size so decode needs no -B (the
            # reference leaves this to the user, src/2D-DCT.py:533-579)
            cs.put_json("bopt", {"block_size": int(bopt)})
        if args.vcf_layout:
            total = cs.write_vcf_layout(args.encoded)
        else:
            total = cs.to_file(args.encoded)
        logging.info("wrote %s (%d bytes, %.4f bpp)", args.encoded, total,
                     total * 8 / (img.shape[0] * img.shape[1]))
        return 0

    if args.command == "decode":
        from vcf_tpu_torch.io import write_image
        from vcf_tpu_torch.pipeline import Codec
        from vcf_tpu_torch.codestream import CodeStream

        try:
            cs = CodeStream.from_file(args.encoded)
        except ValueError:
            # payload written with --vcf-layout: sidecars live next to it
            cs = CodeStream.read_vcf_layout(args.encoded)
        config = config_from_args(args)
        if "bopt" in cs:
            config = config.replace(
                block_size=int(cs.get_json("bopt")["block_size"]))
        rec = Codec(config, device).decode(cs)
        write_image(args.decoded, rec)
        logging.info("wrote %s", args.decoded)
        return 0

    if args.command == "rde":
        from vcf_tpu_torch.io import read_image
        from vcf_tpu_torch import metrics
        import glob
        import os

        orig = read_image(args.original)
        dec = read_image(args.decoded)
        # Sum every codestream file incl. sidecars, like the reference's
        # glob over /tmp/encoded* (src/RDE.py:91-99).  A single-file
        # codestream matches its own prefix, so both layouts work.
        nbytes = sum(
            os.path.getsize(p)
            for p in sorted(glob.glob(args.encoded + "*"))
            if os.path.isfile(p)
        )
        if nbytes == 0:
            nbytes = os.path.getsize(args.encoded)
        report = {
            "rate_bpp": nbytes * 8 / (orig.shape[0] * orig.shape[1]),
            "distortion_rmse": metrics.rmse(orig, dec),
        }
        report["J"] = report["rate_bpp"] + report["distortion_rmse"]
        print(json.dumps(report))
        return 0

    if args.command == "video-encode":
        from vcf_tpu_torch.io.video import read_video
        from vcf_tpu_torch import video

        frames = read_video(args.original, n_frames=args.n_frames)
        codec = video.get(video_config_from_args(args), config_from_args(args),
                          device)
        cs = codec.encode(frames)
        total = cs.to_file(args.encoded)
        n, h, w = frames.shape[:3]
        logging.info("wrote %s (%d bytes, %.4f bpp)", args.encoded, total,
                     total * 8 / (n * h * w))
        return 0

    if args.command == "video-decode":
        from vcf_tpu_torch.io.video import write_video
        from vcf_tpu_torch.codestream import CodeStream
        from vcf_tpu_torch import video

        cs = CodeStream.from_file(args.encoded)
        codec = video.get(video_config_from_args(args), config_from_args(args),
                          device)
        frames = codec.decode(cs)
        write_video(args.decoded, frames)
        logging.info("wrote %s (%d frames)", args.decoded, frames.shape[0])
        if args.preview:
            from vcf_tpu_torch.io.video import write_preview

            for p in write_preview(args.preview, frames):
                logging.info("preview: %s", p)
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
