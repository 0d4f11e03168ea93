"""Percentiles and interval arithmetic used by the readers."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default), or NaN for no values."""
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_length(intervals: Iterable[Interval]) -> float:
    """Total length covered by a set of intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of a set of intervals as sorted, disjoint intervals."""
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def clip(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    """Each interval cut to [lo, hi]; empty ones dropped."""
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def covered_within(inner: Iterable[Interval], outer: Iterable[Interval]) -> float:
    """Length of the union of ``inner`` that lies inside the union of
    ``outer``."""
    total = 0.0
    for lo, hi in merge(outer):
        total += union_length(clip(inner, lo, hi))
    return total


def gaps(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    """The stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for a, b in merge(clip(intervals, lo, hi)):
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        out.append((cur, hi))
    return out


def overlap_share(start: float, end: float, lo: float, hi: float) -> float:
    """The share of [start, end] that lies inside [lo, hi]."""
    if end <= start:
        return 1.0 if lo <= start <= hi else 0.0
    return max(0.0, min(end, hi) - max(start, lo)) / (end - start)
