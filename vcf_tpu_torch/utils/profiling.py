"""Profiler hooks (port of vcf_tpu/utils/profiling.py on torch.profiler).

`trace` and `device_memory_stats` wrap a block of codec work from
outside.  Inside the codec, `span(name)` names a stretch of host code in
whatever `torch.profiler` is active (`trace`, a benchmark's profile, any
other), as a `record_function` range on the same clock as the kernels,
copies and memsets it launches; with no profiler active it is one test
of the profiler flag and a shared no-op context.  The names are
`vcf.<module>.<what>`, first the wrappers and loops:

    vcf.dct.forward, vcf.dct.inverse    B1-B4's launches
    vcf.dwt.analyze, vcf.dwt.synthesize the DWT lane grid's colour, bank,
                                        quantizer and byte planes, and back
    vcf.rans.encode, vcf.rans.compact, vcf.rans.assemble, vcf.rans.decode
                                        K1, K2 and its row mode,
                                        assemble_stream, K3 and the grid
                                        decode (both modes)
    vcf.motion.search, vcf.motion.compensate
                                        the SAD and MC wrappers
    vcf.ipp.encode, vcf.ipp.decode      the planar IPP grid loop

then the kinds of work inside them, selected by their last part:

    vcf.dct.layout, vcf.dwt.layout, vcf.rans.layout, vcf.ipp.layout
                copies that only move bytes: the DCT wrapper's planar
                copy, the DWT bands <-> lane grid copies, the lane
                layouts and K1's (L, S) copy, the IPP loop's output stacks
    vcf.rans.sync       device-to-host read-backs of the rANS wrappers
    vcf.rans.tables     pack_tables
    vcf.dwt.bank        one level of the DWT bank (ops/cuda/dwt_kernel.py)
    vcf.ipp.luma        the IPP loop's luma chains
    vcf.ipp.pixels      its elementwise residual, reconstruction and casts

`count(name, n)` adds to one of two process-wide counters, always on:
`layout_bytes` (bytes read plus bytes written by the layout copies) and
`host_syncs` (read-backs of CUDA tensors); `counts()` returns a copy.
"""

from __future__ import annotations

import collections
import contextlib
import os
from typing import Dict

import torch

#: the no-op context every span is while no profiler runs
_NULL = contextlib.nullcontext()
#: the counters `count` takes
COUNTERS = ("layout_bytes", "host_syncs")
_COUNTS: collections.Counter = collections.Counter()


def span(name: str):
    """A `record_function(name)` range while a torch.profiler is active,
    else one shared no-op context:

        with profiling.span("vcf.rans.sync"):
            ..."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


def count(name: str, n: int = 1) -> None:
    """Add n to the process-wide counter `name` (one of COUNTERS)."""
    if name not in COUNTERS:
        raise KeyError(f"no counter {name!r}; the counters are {COUNTERS}")
    _COUNTS[name] += n


def counts() -> Dict[str, int]:
    """A copy of the counters (a counter never added to reads 0)."""
    return {name: _COUNTS[name] for name in COUNTERS}


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the CPU and, where a card is
    visible, CUDA activity around a block of codec work, and write it to
    `log_dir` as one Chrome trace (viewable in Perfetto or
    chrome://tracing):

        with profiling.trace("traces") as d:
            codec.encode(img)

    Yields `log_dir`; the trace is `log_dir/trace.json` once the block
    ends, the codec's `vcf.*` spans in it."""
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
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}
