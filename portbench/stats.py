"""The metric arithmetic of the end-to-end metrics and the trace."""

from __future__ import annotations

import math
import statistics


def rate_ms(wall_s: float, frames: int) -> float:
    """Milliseconds a frame over a whole window: all its work over all its
    time."""
    if frames <= 0:
        raise ValueError("no frame was presented in the window")
    return wall_s * 1e3 / frames


def p95(values) -> float:
    """The 95th percentile by nearest rank, over every value."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def spread(values) -> float:
    """Distance between the first and third quartile as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def union_length(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def merged(intervals) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out
