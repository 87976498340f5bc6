"""Order statistics over every sample, and the union of busy intervals."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) of all values, linear between order
    statistics (numpy's default "linear" method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values) -> float:
    """Interquartile distance over the median, with Python's default quartiles."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals; overlaps count once."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def gaps(intervals, window_start: float, window_end: float):
    """(start, end) of every stretch of [window_start, window_end] no interval covers."""
    out, cursor = [], window_start
    for start, end in sorted(intervals):
        if start > cursor:
            out.append((cursor, min(start, window_end)))
        cursor = max(cursor, end)
        if cursor >= window_end:
            break
    if cursor < window_end:
        out.append((cursor, window_end))
    return [(a, b) for a, b in out if b > a]
