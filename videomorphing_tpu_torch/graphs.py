"""CUDA graphs: the test of whether work can be a replay, the one capture
and replay, cached device constants that a graph can hold on to, and a
bounded cache of graphs.

A CUDA graph replays its launches on the addresses it was captured with.
A tensor that it reads but did not allocate, such as a DCT basis that an
LRU cache hands out, must live as long as the graph: freed and reused,
its memory would be read as garbage, with no error. :func:`constant_cache`
is ``functools.lru_cache`` for functions that return such tensors; while
:func:`collect_constants` is open, every tensor they hand out, hit or miss,
is also appended to the list it yields, for the graph's owner to keep.

A kernel wrapper counts its launches in its ``launches*`` attributes; a
capture runs nothing, so :func:`capture` takes back what the captured
launches counted, and :meth:`Captured.replay` adds it on every replay.
"""

from __future__ import annotations

import collections
import contextlib
import functools
from typing import Callable, Dict, Hashable, NamedTuple, Optional, Sequence

import torch

_collected: Optional[list] = None


def replayable(tensors: Sequence) -> bool:
    """Whether work on ``tensors`` can run as a replay of a captured CUDA
    graph: every one a tensor on one card, no capture open on the current
    stream, no gradient wanted."""
    if not tensors or not all(isinstance(t, torch.Tensor) for t in tensors):
        return False
    dev = tensors[0].device
    return (dev.type == "cuda" and all(t.device == dev for t in tensors)
            and not torch.cuda.is_current_stream_capturing()
            and not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)))


def constant_cache(maxsize: int):
    """``functools.lru_cache(maxsize=maxsize)`` whose results are also
    collected while :func:`collect_constants` is open; the cached function
    keeps ``cache_clear`` and ``cache_info``."""

    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def get(*args, **kwargs):
            out = cached(*args, **kwargs)
            if _collected is not None:
                _collected.append(out)
            return out

        get.cache_clear, get.cache_info = cached.cache_clear, cached.cache_info
        return get

    return wrap


@contextlib.contextmanager
def collect_constants():
    """Yield a list that receives every :func:`constant_cache` result handed
    out inside the block."""
    global _collected
    prev, _collected = _collected, []
    try:
        yield _collected
    finally:
        _collected = prev


class Captured(NamedTuple):
    """The CUDA graphs of :func:`capture`, by step name."""

    graphs: Dict[Hashable, "torch.cuda.CUDAGraph"]
    outputs: Dict[Hashable, object]  # what each step's captured run returned: the buffers its graph writes
    launches: Dict[Hashable, tuple]  # ((kernel wrapper, counter, launches in one replay), ...)
    constants: tuple                 # cached constants the graphs read, held alive

    def replay(self, name: Hashable) -> None:
        """Replay step ``name``'s graph and advance the launch counters by
        its launches."""
        self.graphs[name].replay()
        for fn, k, n in self.launches[name]:
            setattr(fn, k, getattr(fn, k) + n)


def capture(steps: Dict[Hashable, Callable[[], object]], device, counted: Sequence) -> Captured:
    """CUDA graphs of ``steps`` (name -> a function of no arguments) on
    ``device``, in one new memory pool. Every step runs once on a side
    stream that waits on the current one (which builds the kernels and
    fills the constant caches, whose host-to-device copies cannot be
    captured), the current stream waits on it, then each step is captured
    on it, the constants collected. The counters of ``counted`` (every
    ``launches*`` attribute of each kernel wrapper) keep only what ran."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        for step in steps.values():
            step()
    current.wait_stream(side)
    pool = torch.cuda.graph_pool_handle()
    graphs, outputs, launches = {}, {}, {}
    with collect_constants() as constants, torch.cuda.stream(side):
        for name, step in steps.items():
            before = {(fn, k): n for fn in counted for k, n in vars(fn).items() if k.startswith("launches")}
            graphs[name] = torch.cuda.CUDAGraph()
            graphs[name].capture_begin(pool=pool)
            try:
                outputs[name] = step()
            finally:
                graphs[name].capture_end()
            launches[name] = tuple((fn, k, getattr(fn, k) - n) for (fn, k), n in before.items()
                                   if getattr(fn, k) != n)
            for fn, k, _ in launches[name]:
                setattr(fn, k, before[fn, k])
    return Captured(graphs, outputs, launches, tuple(constants))


class LRU:
    """At most ``size`` entries by key, the least recently used dropped
    first. A miss drops before it makes the new entry, so that what the
    dropped entry held (a graph's memory pool) is free by then."""

    def __init__(self, size: int):
        self.size = size
        self._entries: "collections.OrderedDict[Hashable, object]" = collections.OrderedDict()

    def get(self, key: Hashable, make: Callable[[], object]):
        """The entry of ``key``, made by ``make()`` on a miss."""
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
            return entry
        while len(self._entries) >= self.size:
            self._entries.popitem(last=False)
        entry = self._entries[key] = make()
        return entry

    def keys(self) -> list:
        """The keys, least recently used first."""
        return list(self._entries)

    def clear(self) -> None:
        self._entries.clear()
