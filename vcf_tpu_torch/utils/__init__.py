"""Cross-cutting utilities: timing."""

from vcf_tpu_torch.utils.timing import StageTimer, timed_stage

__all__ = ["StageTimer", "timed_stage"]
