"""Shared arithmetic of the end-to-end metrics."""

from __future__ import annotations

import statistics


def gbps(rec: dict, half: str) -> float:
    """Pixel bytes of every clip the half coded, over its wall time."""
    h = rec[half]
    return (h["calls"] - h["failed"]) * rec["work"]["pixel_bytes"] / (
        h["wall_s"] * 1e9)


def p95_ms(rec: dict, half: str) -> float:
    """95th percentile of one call's latency over every call of the half."""
    return statistics.quantiles(rec[half]["ms"], n=20, method="inclusive")[18]
