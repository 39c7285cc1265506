"""Per-stage timing (port of vcf_tpu/utils/timing.py).

`StageTimer` collects named wall-clock spans; `Codec` keeps one per
encode/decode call in `codec.last_timings`.  CUDA work is asynchronous,
so a timer built for a CUDA device synchronizes that device before it
reads the clock at either end of a span: every span then measures
completed work, not the enqueue.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch


class StageTimer:
    def __init__(self, device: Optional[torch.device] = None) -> None:
        self.spans: List[Tuple[str, float]] = []
        self.device = torch.device(device) if device is not None else None

    def _clock(self) -> float:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = self._clock()
        try:
            yield
        finally:
            self.spans.append((name, self._clock() - t0))

    @property
    def total(self) -> float:
        return sum(dt for _, dt in self.spans)

    def as_dict(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, dt in self.spans:
            out[name] = out.get(name, 0.0) + dt
        return out

    def report(self) -> str:
        lines = [f"{name:<24s} {dt * 1000:9.2f} ms" for name, dt in self.spans]
        lines.append(f"{'total':<24s} {self.total * 1000:9.2f} ms")
        return "\n".join(lines)


@contextlib.contextmanager
def timed_stage(timer: Optional[StageTimer], name: str):
    """No-op when timer is None."""
    if timer is None:
        yield
    else:
        with timer.stage(name):
            yield
