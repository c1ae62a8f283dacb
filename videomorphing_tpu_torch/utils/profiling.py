"""Named phases of the pipeline, and their walls when asked for.

Port of ``videomorphing_tpu/utils/profiling.py``'s ``phase_scope``: each
phase is a ``torch.profiler.record_function`` range, so a profiler trace
segments by phase. Inside :func:`record_phases` every phase also
synchronizes the card on entry and exit and adds its host wall (seconds) to
the recording; :func:`note` adds a value under a name. Outside a recording
a phase costs one ``record_function`` and no synchronization.

    with profiling.record_phases() as rec:
        api.morph_clips(clip_a, clip_b, device="cuda")
    rec["flows"], rec["warm_loop"], rec["warm_iters"]
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Optional

import torch

_recording: Optional[Dict[str, Any]] = None


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def phase_scope(name: str):
    """A named phase: a profiler range, timed while a recording is open."""
    with torch.profiler.record_function(name):
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
