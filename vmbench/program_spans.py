"""The program's own spans, as the per-layer readers use them: the log of
``videomorphing_tpu_torch.utils.profiling.spans()``, which a traced run
fills with the traced morphs alone (the warm-up runs with tracing off).
A program that keeps no such log gives nothing, and its readers None."""

from __future__ import annotations

import bisect
from typing import List, Optional, Sequence, Tuple


def named(name: str) -> list:
    """The program's logged spans called ``name``, in the order they closed
    ([] where the program keeps no log)."""
    try:
        from videomorphing_tpu_torch.utils import profiling
    except ImportError:
        return []
    log = getattr(profiling, "spans", None)
    return [s for s in log() if s.name == name] if log is not None else []


def seconds(s) -> Tuple[float, float]:
    """A span's start and end in seconds on the profiler's clock, as
    ``vmbench.trace`` keeps the device's activities."""
    return s.start_ns * 1e-9, s.end_ns * 1e-9


def length_s(spans: Sequence) -> float:
    return sum(s.end_ns - s.start_ns for s in spans) * 1e-9


def per_iter(levels: Sequence, counter: str) -> Optional[float]:
    """A ``solve.level`` counter summed over the levels, over their
    iterations summed; None where either is 0."""
    iters = sum(int(s.attrs.get("iters", 0)) for s in levels)
    n = sum(int(s.counts.get(counter, 0)) for s in levels)
    return n / iters if iters > 0 and n > 0 else None


def starts_within(starts: List[float], a: float, b: float) -> int:
    """How many of the ascending ``starts`` lie in [a, b]."""
    return bisect.bisect_right(starts, b) - bisect.bisect_left(starts, a)


def covered_within(merged: Sequence[Tuple[float, float]], windows: Sequence[Tuple[float, float]]) -> float:
    """The length of the ``windows`` that the ascending, disjoint ``merged``
    intervals cover, summed over the windows."""
    los = [lo for lo, _ in merged]
    total = 0.0
    for a, b in windows:
        i = max(bisect.bisect_right(los, a) - 1, 0)
        while i < len(merged) and merged[i][0] < b:
            total += max(0.0, min(merged[i][1], b) - max(merged[i][0], a))
            i += 1
    return total
