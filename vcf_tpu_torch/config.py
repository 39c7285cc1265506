"""Explicit codec configuration (port of vcf_tpu/config.py).

`CodecConfig` and `VideoConfig` are copied verbatim so a config means
the same pipeline in both packages.

The reference composes its pipeline by dynamic class inheritance driven by
argparse flags accreted at import time (reference: src/parser.py:72-80,
src/2D-DCT.py:36-56, src/deadzone.py:30-46).  Here the same composition is
an explicit, hashable dataclass: one field per pipeline stage plus the
per-stage knobs.

Stage name parity with VCF flags (for the CLI in vcf_tpu.cli):

    VCF flag                     config field        values
    --------------------------   -----------------   -------------------------------
    -T/--transform, --st         spatial             dct dwt klt mdct lbt none
    -t/--color_transform         color               ycocg ycrcb cdct none
    -a/--quantizer               quantizer           deadzone lloydmax vq colorvq
    -f/--filter                  filter              none gaussian nlm bm3d
    -c/--entropy_image_codec     entropy             tiff png pnm zlib huffman cbahc cbaac
"""

from __future__ import annotations

import dataclasses
SPATIAL_TRANSFORMS = ("dct", "dwt", "klt", "mdct", "lbt", "none")
COLOR_TRANSFORMS = ("ycocg", "ycocg_r", "ycrcb", "cdct", "none")
QUANTIZERS = ("deadzone", "lloydmax", "vq", "colorvq", "none")
FILTERS = ("none", "gaussian", "nlm", "bm3d")
ENTROPY_CODECS = ("tiff", "png", "pnm", "zlib", "huffman", "ihuff", "rans",
                  "srans", "grans", "cgrans", "cbahc", "cbaac")


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Configuration of one still-image codec pipeline.

    Defaults mirror VCF's defaults: YCoCg + 8x8 block DCT with subband
    reordering + deadzone QSS=32 + TIFF(zlib) entropy stage
    (reference: src/2D-DCT.py:30, src/deadzone.py:22, src/no_filter.py:12).
    """

    # ---- stage selection -------------------------------------------------
    spatial: str = "dct"
    color: str = "ycocg"
    quantizer: str = "deadzone"
    filter: str = "none"
    entropy: str = "tiff"

    # ---- spatial transform knobs ----------------------------------------
    block_size: int = 8          # -B  (dct/klt/mdct/lbt block size)
    subbands: bool = True        # not -x  (coefficient->subband reorder)
    perceptual: bool = False     # -p  (JPEG-table coefficient prescale)
    dwt_levels: int = 5          # -l
    wavelet: str = "db5"         # -w
    lbt_epochs: int = 1000       # --epochs (2D-LBT.py:40 default)
    lbt_lr: float = 1e-3         # --lr
    lbt_lambda: float = 0.0      # -L regularizer weight for LBT training
    # --side_info: external path for the trained LBT weights instead of
    # carrying them inside the codestream (2D-LBT.py:39,48,391-398)
    lbt_side_info: str = ""

    # ---- quantizer knobs -------------------------------------------------
    qss: int = 32                # -q for deadzone / lloydmax
    q_min: int = -2048           # -m (lloydmax histogram support)
    q_max: int = 2047            # -n
    vq_block_size: int = 4       # -b
    vq_clusters: int = 256       # -q for vq
    colorvq_clusters: int = 32   # -q for colorvq
    seed: int = 0                # RNG seed for VQ / k-means (reference is unseeded)

    # ---- filter knobs ----------------------------------------------------
    filter_size: int = 5         # -s gaussian kernel size
    nlm_h: float = 10.0          # -H
    nlm_template: int = 7        # -t
    nlm_search: int = 21         # -s
    bm3d_sigma: float = 25.0     # -s for bm3d

    # ---- entropy knobs ---------------------------------------------------
    context_order: int = 1       # --order for cbahc/cbaac
    context_tiles: int = 1       # >1: independent per-tile adaptive streams
                                 # (parallel encode/decode, SURVEY §7.3)
    context_classes: int = 4     # --classes for cgrans: 4 (speed) or 15
                                 # (rate priority, ~-19% vs order-0)
    zlib_level: int = 6

    # ---- execution knobs -------------------------------------------------
    use_pallas: bool = True      # BatchCodec: True takes the fused kernels
                                 # (B1-B4; their plain versions on the CPU),
                                 # False the unfused torch route

    def __post_init__(self):
        def _check(value, allowed, what):
            if value not in allowed:
                raise ValueError(f"unknown {what} {value!r}; expected one of {allowed}")

        _check(self.spatial, SPATIAL_TRANSFORMS, "spatial transform")
        _check(self.color, COLOR_TRANSFORMS, "color transform")
        _check(self.quantizer, QUANTIZERS, "quantizer")
        _check(self.filter, FILTERS, "filter")
        _check(self.entropy, ENTROPY_CODECS, "entropy codec")
        if self.block_size < 2:
            raise ValueError("block_size must be >= 2")
        if self.qss < 1:
            raise ValueError("qss must be >= 1")
        if self.context_classes not in (4, 15):
            raise ValueError("context_classes must be 4 or 15")

    def replace(self, **kw) -> "CodecConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class VideoConfig:
    """Configuration of the temporal (video) layer.

    mode="iii": every frame intra-coded (reference: src/III.py).
    mode="ipp": GOP-structured I+P with block motion compensation
    (reference: src/IPP_DCT.py).
    """

    mode: str = "iii"            # "iii" | "ipp"
    n_frames: int = 20           # -N
    gop_size: int = 10           # -G
    me_block: int = 16           # -M motion-estimation block size
    search_range: int = 8        # -S full-search window (+-S)
    fast_search: bool = False    # three-step search instead of full search
    rdo_lambda: float = 0.0      # -R per-block intra/inter RDO (0 = off)

    def __post_init__(self):
        if self.mode not in ("iii", "ipp"):
            raise ValueError(f"unknown video mode {self.mode!r}")
        if self.gop_size < 1:
            raise ValueError("gop_size must be >= 1")
