"""The arithmetic of a run's window and of a device trace's intervals."""

from __future__ import annotations

import statistics
from typing import Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]


def window_rate(morphs: Sequence[Tuple[float, float, int]]) -> Tuple[float, float, int]:
    """``(frames per second, window seconds, frames)`` of whole morphs
    ``(start, end, frames)``: every frame over the time from the first
    morph's start to the last morph's end."""
    if not morphs:
        raise ValueError("no morph finished in the window")
    t0 = min(m[0] for m in morphs)
    t1 = max(m[1] for m in morphs)
    frames = sum(m[2] for m in morphs)
    return frames / (t1 - t0), t1 - t0, frames


def percentile(values: Sequence[float], q: int) -> float:
    """The ``q``-th percentile, interpolated between the order statistics
    (``statistics.quantiles``' inclusive method); one value is its own."""
    if not values:
        raise ValueError("no values")
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as a share of
    the median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def union(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    """The intervals clipped to [lo, hi] and merged, in order."""
    out: List[Interval] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def covered(intervals: Sequence[Interval]) -> float:
    """Total length of merged intervals."""
    return sum(b - a for a, b in intervals)


def gaps(merged: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The parts of [lo, hi] that merged intervals leave uncovered."""
    out: List[Interval] = []
    t = lo
    for a, b in merged:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out
