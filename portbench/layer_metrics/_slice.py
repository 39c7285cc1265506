"""Shared arithmetic of the per-layer metrics: device time per call of a
benchmark span in a half's profiled slice, and a roofline share."""

from __future__ import annotations


def per_call_s(rec: dict, half: str, span: str, kernel: str = ""):
    """Device seconds per call of the items launched under `span` (and
    named with `kernel`) in the half's slice; None where there are none."""
    t = rec[half]["trace"]
    if t is None or not t.has_span(span):
        return None
    s = t.span_s(span, kernel)
    return s / t.calls if s > 0 else None


def share_pct(least_s: float, measured_s):
    """The least time's share of the measured time, in %."""
    return None if measured_s is None else 100.0 * least_s / measured_s


def idle_pct(rec: dict, half: str):
    t = rec[half]["trace"]
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
