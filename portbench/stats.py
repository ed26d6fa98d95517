"""The arithmetic a run reduces its records with."""

from __future__ import annotations

import math


def p95(values) -> float:
    """The 95th percentile by nearest rank: the smallest sample that at
    least 95% of all samples do not exceed."""
    xs = sorted(values)
    if not xs:
        raise ValueError("p95 of no samples")
    return xs[max(math.ceil(0.95 * len(xs)) - 1, 0)]


def union_length(intervals) -> float:
    """Total length covered by [start, end) intervals (overlaps once)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, start: float, end: float) -> list:
    """[(gap start, gap end)] of [start, end) that no interval covers."""
    out, at = [], start
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, end)))
        at = max(at, e)
        if at >= end:
            break
    if at < end:
        out.append((at, end))
    return [(a, b) for a, b in out if b > a]
