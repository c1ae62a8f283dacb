"""A ``torch.profiler`` trace of the card, read in memory.

:func:`collect` keeps the device's activities (kernels, copies, fills) and
the host's ranges (the harness's spans, the program's phases and the
operators), each as ``(start, end, name)`` in seconds on the profiler's
clock. :class:`Trace` answers what the per-layer metrics and the breakdown
ask: the union of device intervals in the traced window, the kernels by
name, and the idle gaps named by the host range open during them.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from vmbench import stats

Event = Tuple[float, float, str]
COPY_PREFIXES = ("Memcpy", "Memset")


def _times(e) -> Tuple[float, float]:
    start = e.start_ns()
    return start * 1e-9, (start + e.duration_ns()) * 1e-9


class Trace:
    """Device activities and host ranges of one traced window."""

    def __init__(self, device: Sequence[Event], host: Sequence[Event], window: Tuple[float, float]):
        self.device = sorted(device)
        self.host = sorted(host)
        self.lo, self.hi = window
        self.busy = stats.union(((a, b) for a, b, _ in self.device), self.lo, self.hi)

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    @property
    def busy_s(self) -> float:
        return stats.covered(self.busy)

    def kernels(self) -> List[Event]:
        """Device kernels in the window (no copies or fills), in start order."""
        return [e for e in self.device
                if not e[2].startswith(COPY_PREFIXES) and e[1] > self.lo and e[0] < self.hi]

    def device_ops(self, top: int = 10) -> List[list]:
        """``[name, seconds]`` of the device operations that took most time."""
        acc: Dict[str, float] = defaultdict(float)
        for a, b, name in self.device:
            if b > self.lo and a < self.hi:
                acc[short_name(name)] += min(b, self.hi) - max(a, self.lo)
        return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """``[name, seconds]``: the device's idle time in the window, summed
        by what the host was doing in the middle of each gap (the innermost
        named range, then the innermost operator: ``"solve > aten::item"``),
        the largest first."""
        gaps = stats.gaps(self.busy, self.lo, self.hi)
        mids = [0.5 * (a + b) for a, b in gaps]
        ranges = innermost([e for e in self.host if not e[2].startswith("aten::")], mids)
        ops = innermost([e for e in self.host if e[2].startswith("aten::")], mids)
        acc: Dict[str, float] = defaultdict(float)
        for (a, b), name, op in zip(gaps, ranges, ops):
            name = name or "host"
            acc[f"{name} > {op}" if op else name] += b - a
        return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:top]]


def innermost(events: Sequence[Event], times: Sequence[float]) -> List[Optional[str]]:
    """For each of the ascending ``times``, the name of the innermost of
    the nested ``events`` (sorted by start) open at it, or None."""
    out: List[Optional[str]] = []
    stack: List[Event] = []
    i = 0
    for t in times:
        while i < len(events) and events[i][0] <= t:
            while stack and stack[-1][1] < events[i][0]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return (name if name.startswith(COPY_PREFIXES) else name.split("(", 1)[0])[:120]


def collect(prof, window_range: str, host_ranges: Sequence[str]) -> Trace:
    """The trace of a finished ``torch.profiler.profile``. The window runs
    from the first start to the last end of the host range ``window_range``;
    the host events kept are the ranges named in ``host_ranges`` and the
    operators (``aten::``). A ``record_function`` range also has a copy on
    the device's timeline, which spans kernels and is no activity of its
    own: it is left out."""
    from torch.autograd import DeviceType

    device: List[Event] = []
    host: List[Event] = []
    wins: List[Tuple[float, float]] = []
    names = set(host_ranges)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and name not in names and name != window_range:
                device.append(_times(e) + (name,))
        elif name == window_range:
            wins.append(_times(e))
        elif name.startswith("aten::") or name in names:
            host.append(_times(e) + (name,))
    if not wins:
        raise RuntimeError(f"the trace holds no {window_range!r} range")
    return Trace(device, host, (min(a for a, _ in wins), max(b for _, b in wins)))
