"""Cross-cutting utilities: timing (and, in `utils.profiling`, the
profiler hooks)."""

from vcf_tpu_torch.utils.timing import StageTimer, timed_stage

__all__ = ["StageTimer", "timed_stage"]
