"""Profiler hooks (port of vcf_tpu/utils/profiling.py on torch.profiler).

Nothing on the codec paths calls these: they wrap a block of codec work
from outside, as a benchmark's profile does.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the CPU and, where a card is
    visible, CUDA activity around a block of codec work, and write it to
    `log_dir` as one Chrome trace (viewable in Perfetto or
    chrome://tracing):

        with profiling.trace("traces") as d:
            codec.encode(img)

    Yields `log_dir`; the trace is `log_dir/trace.json` once the block
    ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats() -> Dict:
    """torch.cuda.memory_stats of each visible card by its name
    ("cuda:0", ...); {} where there is none."""
    import torch

    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}
