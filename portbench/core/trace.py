"""Reading a `torch.profiler` trace of a slice of one half of the window.

The device items are the trace's kernels, copies and memsets.  Each is
charged to the benchmark spans (`record_function("portbench.<name>")`)
that were open on the host when the runtime call that launched it ran
(the two share a correlation id).  Busy time is the union of the device
intervals inside the slice, which runs from the start of the first
profiled call to the end of the last; each idle gap is charged to the
host op that launched the device item after it (the method of
`profile_decode.py`).
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
PREFIX = "portbench."
CALL = PREFIX + "call"


class HalfTrace:
    """What one profiled slice of calls shows."""

    def __init__(self, events: list, calls: int):
        self.calls = calls
        spans = collections.defaultdict(list)
        for e in events:
            if (e.get("cat") == "user_annotation" and "dur" in e
                    and e.get("name", "").startswith(PREFIX)):
                spans[e["name"][len(PREFIX):]].append(
                    (e["ts"], e["ts"] + e["dur"]))
        self._spans = {k: sorted(v) for k, v in spans.items()}
        calls_iv = self._spans.get(CALL[len(PREFIX):], [])
        if not calls_iv:
            raise RuntimeError("the trace holds no profiled call")
        self.t0, self.t1 = calls_iv[0][0], max(b for _, b in calls_iv)
        runtime = {}
        for e in events:
            if e.get("cat") in RUNTIME_CATS and "dur" in e:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    runtime[corr] = e
        ops = sorted((e for e in events
                      if e.get("cat") == "cpu_op" and "dur" in e),
                     key=lambda e: e["ts"])
        top, end = [], float("-inf")
        for e in ops:                       # outermost ops, disjoint
            if e["ts"] >= end:
                top.append(e)
                end = e["ts"] + e["dur"]
        top_ts = [e["ts"] for e in top]
        self.items = []
        for e in events:
            if e.get("cat") not in DEVICE_CATS or "dur" not in e:
                continue
            call = runtime.get(e.get("args", {}).get("correlation"))
            launch = call["ts"] if call else None
            if launch is not None and not self.t0 <= launch <= self.t1:
                continue
            if launch is None and not self.t0 <= e["ts"] <= self.t1:
                continue
            self.items.append((e["ts"], e["dur"], e["name"], launch,
                               self._launcher(call, top, top_ts)))
        self.items.sort()
        self.attributed = sum(1 for it in self.items if it[3] is not None)

    def _launcher(self, call, top, top_ts) -> str:
        if call is None:
            return "?"
        t = call["ts"]
        i = bisect.bisect_right(top_ts, t) - 1
        what = call["name"]
        if i >= 0 and top[i]["ts"] + top[i]["dur"] >= t:
            what = f"{top[i]['name']} / {what}"
        inner = self.spans_at(t)
        return f"{inner[-1]}: {what}" if inner else what

    def spans_at(self, t: float) -> list:
        """Names of the benchmark spans open at host time t, outer first
        (the per-call span left out)."""
        found = []
        for name, iv in self._spans.items():
            if name == CALL[len(PREFIX):]:
                continue
            i = bisect.bisect_right(iv, (t, float("inf"))) - 1
            if i >= 0 and iv[i][0] <= t <= iv[i][1]:
                found.append((iv[i][0], name))
        return [name for _, name in sorted(found)]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        busy, end = 0.0, self.t0
        for ts, dur, *_ in self.items:
            a, b = max(ts, end), min(ts + dur, self.t1)
            if b > a:
                busy += b - a
            end = max(end, min(ts + dur, self.t1))
        return busy / 1e6

    def span_s(self, span: str, kernel: str = "") -> float:
        """Device seconds of the items launched inside span `span` (and
        whose name holds `kernel`)."""
        iv = self._spans.get(span, [])
        total = 0.0
        for ts, dur, name, launch, _ in self.items:
            if launch is None or kernel not in name:
                continue
            i = bisect.bisect_right(iv, (launch, float("inf"))) - 1
            if i >= 0 and iv[i][0] <= launch <= iv[i][1]:
                total += dur
        return total / 1e6

    def has_span(self, span: str) -> bool:
        return span in self._spans

    def span_names(self) -> list:
        """The benchmark spans of the slice, the per-call span left out."""
        return [k for k in self._spans if k != CALL[len(PREFIX):]]

    def device_ops(self) -> dict:
        by = collections.Counter()
        for _, dur, name, *_ in self.items:
            by[name] += dur / 1e6
        return by

    def idle_gaps(self) -> dict:
        """Idle seconds inside the slice, by the launcher of the device
        item that ended each gap (the slice's tail: "end of call")."""
        by = collections.Counter()
        end = self.t0
        for ts, dur, _, _, who in self.items:
            if ts > end:
                by[who] += (ts - end) / 1e6
            end = max(end, ts + dur)
        if self.t1 > end:
            by["end of call"] += (self.t1 - end) / 1e6
        return by


def read(prof, calls: int) -> HalfTrace:
    """Export `prof`'s Chrome trace to a temporary file, read it, delete
    it."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return HalfTrace(events, calls)
