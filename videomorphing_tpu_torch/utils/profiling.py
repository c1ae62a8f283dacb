"""Spans and counters of the program, named phases and their walls, traces.

Port of ``videomorphing_tpu/utils/profiling.py``, extended with the
port's span log. Tracing is on while a ``torch.profiler`` session is active
or a :func:`record_phases` recording is open. Then:

- :func:`span` opens a ``torch.profiler.record_function`` range of its name
  and, when it closes, appends a :class:`SpanRecord` to an in-memory log:
  its start and end in ns on the profiler's clock (unix ns, the clock of
  kineto's ``start_ns()``), its parent, the top-level span above it, its
  attributes and its counters. It never synchronizes the card.
- :func:`count` adds to a counter of the innermost open span.
- :func:`phase_scope` is a span that, inside a recording, also synchronizes
  the card on entry and exit and adds its host wall (seconds) to the
  recording; :func:`note` adds a value under a name.

Off, a span or a count costs one check: no range, no clock read, no log.
The log is bounded (``LOG_LIMIT`` records; those past it are counted by
:func:`dropped`), read by :func:`spans` and emptied by :func:`clear`. Spans
nest on one stack: open them from one thread.

    with profiling.record_phases() as rec:
        api.morph_clips(clip_a, clip_b, device="cuda")
    rec["flows"], rec["warm_loop"], rec["warm_iters"]
    [s for s in profiling.spans() if s.name == "solve.level"]

:func:`trace_to` writes a ``torch.profiler`` Chrome trace of a block.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

LOG_LIMIT = 1 << 18

_recording: Optional[Dict[str, Any]] = None


class SpanRecord(NamedTuple):
    """A closed span. ``start_ns``/``end_ns``: the profiler's clock (unix
    ns); ``parent``: the enclosing span's ``id`` (None at the top);
    ``trace``: the ``id`` of the top-level span it lies under (its own at
    the top)."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    trace: int
    attrs: Dict[str, Any]
    counts: Dict[str, int]


_log: List[SpanRecord] = []
_dropped = 0
_stack: List["_Span"] = []
_ids = itertools.count(1)


def tracing() -> bool:
    """Whether spans are recorded: a profiler session or a recording is open."""
    return _recording is not None or _autograd_profiler._is_profiler_enabled


class _Off:
    """The span of tracing off: enters and leaves, and records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "counts", "id", "parent", "trace", "start_ns", "_range")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name, self.attrs, self.counts = name, attrs, {}

    def __enter__(self):
        up = _stack[-1] if _stack else None
        self.id = next(_ids)
        self.parent = None if up is None else up.id
        self.trace = self.id if up is None else up.trace
        _stack.append(self)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.start_ns = time.time_ns()  # just inside the range: the two ends agree
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        self._range.__exit__(*exc)
        _stack.pop()
        global _dropped
        if len(_log) < LOG_LIMIT:
            _log.append(SpanRecord(self.name, self.start_ns, end_ns, self.id, self.parent, self.trace,
                                   self.attrs, self.counts))
        else:
            _dropped += 1
        return False

    def set(self, **attrs) -> None:
        """Add attributes, e.g. what is known only on exit."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A named span with attributes; ``with span(...) as s: s.set(k=v)``."""
    if not tracing():
        return _OFF
    return _Span(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the innermost open span."""
    if _stack:
        counts = _stack[-1].counts
        counts[name] = counts.get(name, 0) + n


def spans() -> List[SpanRecord]:
    """The logged spans, in the order they closed."""
    return list(_log)


def dropped() -> int:
    """Spans closed while the log was full, since the last :func:`clear`."""
    return _dropped


def clear() -> None:
    """Empty the log."""
    global _dropped
    _log.clear()
    _dropped = 0


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def phase_scope(name: str):
    """A named phase: a span, timed while a recording is open."""
    with span(name):
        if _recording is None:
            yield
            return
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            _recording[name] = _recording.get(name, 0.0) + time.perf_counter() - t0


def note(name: str, value: Any) -> None:
    """Record ``value`` under ``name`` while a recording is open."""
    if _recording is not None:
        _recording[name] = value


@contextlib.contextmanager
def record_phases():
    """Open a recording; yields the dict that phases and notes fill."""
    global _recording
    prev, _recording = _recording, {}
    try:
        yield _recording
    finally:
        _recording = prev


@contextlib.contextmanager
def trace_to(logdir: Optional[str]):
    """Profile the block (host, and the card when there is one) and write
    a Chrome trace, ``trace.json``, into ``logdir``; no-op when None."""
    if logdir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
