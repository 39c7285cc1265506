"""The program's own spans in a profiled slice of one half of the window.

vcf_tpu_torch opens `vcf.<module>.<what>` spans (`utils.profiling.span`)
whenever a `torch.profiler` is active: `record_function` ranges on the
host, on the clock of the device items in the same trace.  A kind is a
span name's last part (`layout`, `sync`, `luma`, `pixels`, ...).  Read
beside the slice's `trace.HalfTrace`, on the same events:

- `program_s(kind)`: device seconds of the items whose launch ran while
  a span of that kind was open (an item counts once, however many such
  spans were open);
- `idle_in_s(kind)`: idle seconds of the gaps that open while a span of
  that kind is open on the host (a gap opens where the device's last
  busy interval ends: a read-back's copy ending inside its
  `vcf.rans.sync` span opens the gap the host's wait leaves);
- `by_span_s()`: device seconds by the innermost span open at each
  item's launch;
- `idle_gaps()`: `HalfTrace.idle_gaps` with the innermost program span
  open at the next item's launch put after the benchmark span:
  `<benchmark span>: <program span>: <op> / <runtime call>`.
"""

from __future__ import annotations

import bisect
import collections

PREFIX = "vcf."


class ProgramSpans:
    """The `vcf.*` spans of a slice and what the device did inside them."""

    def __init__(self, events: list, half):
        self.half = half
        spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                       for e in events
                       if e.get("cat") == "user_annotation" and "dur" in e
                       and e.get("name", "").startswith(PREFIX))
        self.spans = spans
        self._starts = [s[0] for s in spans]

    def open_at(self, t: float) -> list:
        """Names of the program spans open at host time t, outer first."""
        i = bisect.bisect_right(self._starts, t)
        return [name for a, b, name in self.spans[:i] if b >= t]

    def kind_open(self, kind: str, t: float) -> bool:
        """Whether a span of `kind` is open at host time t."""
        return any(n.endswith("." + kind) for n in self.open_at(t))

    def kinds(self) -> list:
        """Every kind of span in the slice, sorted."""
        return sorted({name.rsplit(".", 1)[1] for *_, name in self.spans})

    def program_s(self, kind: str) -> float:
        total = 0.0
        for _, dur, _, launch, _ in self.half.items:
            if launch is not None and self.kind_open(kind, launch):
                total += dur
        return total / 1e6

    def by_span_s(self) -> dict:
        """Device seconds by the innermost program span open at each
        item's launch (items launched outside every span left out)."""
        by = collections.Counter()
        for _, dur, _, launch, _ in self.half.items:
            inner = self.open_at(launch) if launch is not None else []
            if inner:
                by[inner[-1]] += dur / 1e6
        return by

    def _gaps(self):
        """(opens at, seconds, label of the next item's launcher) of each
        idle gap in the slice, the tail's label "end of call"."""
        end = self.half.t0
        for ts, dur, _, launch, who in self.half.items:
            if ts > end:
                yield end, (ts - end) / 1e6, launch, who
            end = max(end, ts + dur)
        if self.half.t1 > end:
            yield end, (self.half.t1 - end) / 1e6, None, "end of call"

    def idle_in_s(self, kind: str) -> float:
        return sum(s for opens, s, _, _ in self._gaps()
                   if self.kind_open(kind, opens))

    def idle_gaps(self) -> dict:
        by = collections.Counter()
        for _, s, launch, who in self._gaps():
            inner = self.open_at(launch) if launch is not None else []
            if inner:
                bench = self.half.spans_at(launch)
                if bench:
                    head = bench[-1] + ": "
                    who = f"{head}{inner[-1]}: {who[len(head):]}"
                else:
                    who = f"{inner[-1]}: {who}"
            by[who] += s
        return by
