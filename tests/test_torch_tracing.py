"""The port's spans and counters (``utils.profiling``) and the benchmark's
readers of them.

- with tracing off a tiny CPU ``ImageMorpher`` solve and render, and a
  ``MetricsLogger`` phase, enter no ``record_function``, read no clock on
  the span path, synchronize nothing and log nothing;
- under ``torch.profiler`` every logged span lies inside its own range in
  the kineto trace (10 us of slack), within 0.5 ms of it at both ends, and
  nests under its parent;
- a level's ``iters`` are its ``LevelStats.iters``, its ``reads`` are the
  ``.item()``/``.tolist()`` calls made inside it, each a ``host.read``
  span, and it reads once an Armijo trial: an iteration reads once, with
  its first trial, and each backtrack once;
- the log is bounded and counts what it drops; ``phase_scope`` keeps its
  synced walls inside a recording; ``MetricsLogger.phase`` still emits
  its JSON line;
- each of ``vmbench``'s seven readers of the spans returns its value on a
  hand-built log and trace, and None without them.
"""

import gc
import importlib
import io
import json
import time
import types

import numpy as np
import pytest
import torch

from videomorphing_tpu_torch.config import MorphParams, SynthParams
from videomorphing_tpu_torch.models.image_morph import ImageMorpher
from videomorphing_tpu_torch.utils import MetricsLogger, profiling
from vmbench import run as vm_run
from vmbench import trace as vm_trace

torch.set_num_threads(2)
H, W = 40, 48
MP = MorphParams(n_levels=2, iters_coarse=6, iters_fine=3)
SP = SynthParams()
TS = np.array([0.0, 0.5], np.float32)
READERS = ("solve_reads_per_iter", "armijo_trials_per_iter", "solve_read_wait_pct",
           "solve_kernels_per_iter", "solve_device_idle_pct", "render_host_ms_per_frame",
           "solve_fine_device_ms_per_iter")
TOL_NS = 500_000
SLACK_NS = 10_000  # the profiler's conversion of its own clock to unix ns


def _pair(seed=3):
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    out = []
    for shift in (0.0, 1.5):  # one texture, moved
        rng = np.random.default_rng(seed)
        img = np.full((H, W, 3), 0.5)
        for _ in range(6):
            f = rng.uniform(0.08, 0.3, 2)
            ph = rng.uniform(0, 2 * np.pi, 3)
            img += 0.08 * np.sin(f[0] * yy + f[1] * (xx - shift) + ph[:, None, None]).transpose(1, 2, 0)
        out.append(torch.from_numpy(np.clip(img, 0, 1).astype(np.float32)))
    pts = torch.tensor([[[20.0, 20.0], [20.0, 21.5]]])
    return out[0], out[1], pts


def _morph():
    i0, i1, pts = _pair()
    morpher = ImageMorpher(MP, SP, "cpu")
    art = morpher.solve(i0, i1, pts)
    frames = morpher.render(i0, i1, art, TS)
    return art, frames


@pytest.fixture
def fresh():
    profiling.clear()
    yield
    profiling.clear()


def test_tracing_off_enters_no_range_reads_no_clock_and_logs_nothing(fresh, monkeypatch):
    assert not profiling.tracing()
    calls = {"range": 0, "clock": 0, "sync": 0}

    class Range:
        def __init__(self, name):
            calls["range"] += 1

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    def clock():
        calls["clock"] += 1
        return time.time_ns()

    monkeypatch.setattr(torch.profiler, "record_function", Range)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Range)
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(time_ns=clock, perf_counter=clock))
    monkeypatch.setattr(profiling, "_sync", lambda: calls.__setitem__("sync", calls["sync"] + 1))
    _morph()
    with MetricsLogger(stream=io.StringIO()).phase("p"), profiling.phase_scope("q"):
        profiling.count("reads")
    assert profiling.span("x", a=1) is profiling.span("y")
    assert calls == {"range": 0, "clock": 0, "sync": 0}
    assert profiling.spans() == [] and profiling.dropped() == 0 and profiling._stack == []


def _ranges(prof):
    out = {}
    for e in prof.profiler.kineto_results.events():
        out.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return {k: sorted(v) for k, v in out.items()}


def _traced_morph():
    """A profiled tiny morph: (its log, its kineto ranges, its artifacts)."""
    profiling.clear()
    # a collection inside a range's enter or exit would part the two ends by
    # its pause, which says nothing of the clocks
    gc.collect()
    gc.disable()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            art, _ = _morph()
    finally:
        gc.enable()
    return profiling.spans(), _ranges(prof), art


def _offsets_ns(log, ranges):
    """How far each span lies inside its own range, in ns: its start after
    the range's start and its end before the range's end."""
    out = []
    for name in {s.name for s in log}:
        mine = sorted((s.start_ns, s.end_ns) for s in log if s.name == name)
        theirs = ranges[name]
        assert len(mine) == len(theirs), name
        out += [x for (a, b), (c, d) in zip(mine, theirs) for x in (a - c, d - b)]
    return out


def test_spans_share_the_profiler_clock_and_nest(fresh):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("warm"):  # the process's first ranges are slow to open
            pass
    # A span reads its clock after its range opens and before it closes, so
    # on one clock it lies inside the range; another clock would put every
    # span's start or end outside by that clock's offset. How far inside is
    # record_function's own cost, and the host being descheduled inside a
    # range widens it, so a loaded machine gets three tries at TOL_NS.
    for _ in range(3):
        log, ranges, art = _traced_morph()
        offsets = _offsets_ns(log, ranges)
        assert min(offsets) >= -SLACK_NS, sorted(offsets)[:5]
        if max(offsets) <= TOL_NS:
            break
    assert max(offsets) <= TOL_NS, sorted(offsets)[-5:]
    names = {s.name for s in log}
    assert {"morph.solve", "morph.render", "solve.level", "host.read", "render.frame"} <= names
    by_id = {s.id: s for s in log}
    want_parent = {"solve.level": "morph.solve", "host.read": "solve.level", "render.frame": "morph.render"}
    for s in log:
        if s.parent is None:
            assert s.trace == s.id and s.name in ("morph.solve", "morph.render")
            continue
        up = by_id[s.parent]
        assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns
        assert s.trace == up.trace and up.name == want_parent[s.name]
    assert sum(s.name == "render.frame" for s in log) == len(TS)
    assert sum(s.name == "solve.level" for s in log) == len(art.result.level_stats)


def test_level_counters_match_the_solver(fresh, monkeypatch):
    reads = {"n": 0}

    def counted(method):
        def call(self, *a, **k):
            if any(s.name == "solve.level" for s in profiling._stack):
                reads["n"] += 1
            return method(self, *a, **k)
        return call

    monkeypatch.setattr(torch.Tensor, "item", counted(torch.Tensor.item))
    monkeypatch.setattr(torch.Tensor, "tolist", counted(torch.Tensor.tolist))
    with profiling.record_phases():
        art, _ = _morph()
    levels = [s for s in profiling.spans() if s.name == "solve.level"]
    stats = art.result.level_stats
    assert [s.attrs["iters"] for s in levels] == [st.iters for st in stats]
    assert [(s.attrs["h"], s.attrs["w"]) for s in levels] == [(H // 2, W // 2), (H, W)]
    assert sum(s.counts["reads"] for s in levels) == reads["n"] > 0
    for s in levels:
        assert s.counts["reads"] == s.counts["armijo_trials"]
        assert s.counts["armijo_trials"] >= s.attrs["iters"] > 0
        assert sum(r.name == "host.read" and r.parent == s.id for r in profiling.spans()) == s.counts["reads"]


def test_log_is_bounded_and_counts_what_it_drops(fresh, monkeypatch):
    monkeypatch.setattr(profiling, "LOG_LIMIT", 3)
    with profiling.record_phases():
        for i in range(5):
            with profiling.span(f"s{i}", i=i) as s:
                profiling.count("n", 2)
                s.set(done=True)
    assert [s.name for s in profiling.spans()] == ["s0", "s1", "s2"]
    assert profiling.spans()[1].attrs == {"i": 1, "done": True} and profiling.spans()[1].counts == {"n": 2}
    assert profiling.dropped() == 2
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_phase_scope_keeps_its_walls_and_logger_its_line(fresh):
    buf = io.StringIO()
    m = MetricsLogger(stream=buf, verbose=True)
    with profiling.record_phases() as rec:
        with m.phase("outer"), profiling.phase_scope("inner"):
            time.sleep(0.002)
    assert rec["inner"] >= 0.002
    line = json.loads(buf.getvalue())
    assert line["event"] == "phase" and line["name"] == "outer" and line["seconds"] >= 0.002
    inner, outer = profiling.spans()
    assert (inner.name, outer.name) == ("inner", "outer") and inner.parent == outer.id


# --- the readers, on a hand-built log and trace --------------------------------

NS = 1_000_000_000


def _rec(name, a, b, id_, parent=None, attrs=None, counts=None):
    return profiling.SpanRecord(name, int(a * NS), int(b * NS), id_, parent, id_ if parent is None else 1,
                                attrs or {}, counts or {})


LOG = [
    _rec("host.read", 10.1, 10.2, 2, 1), _rec("host.read", 10.5, 10.6, 3, 1),
    _rec("solve.level", 10.0, 11.0, 1, None, {"h": 8, "w": 8, "iters": 4}, {"reads": 9, "armijo_trials": 5}),
    _rec("host.read", 12.1, 12.15, 5, 4),
    _rec("solve.level", 12.0, 12.5, 4, None, {"h": 16, "w": 16, "iters": 2}, {"reads": 5, "armijo_trials": 3}),
    _rec("host.read", 13.0, 13.5, 6),
    _rec("render.frame", 14.0, 14.004, 7), _rec("render.frame", 15.0, 15.006, 8),
]
DEVICE = [(10.05, 10.15, "k1"), (10.3, 10.9, "k2"), (10.95, 11.05, "Memcpy HtoD"),
          (11.5, 11.6, "k4"), (12.2, 12.3, "k3")]
EXPECTED = {
    "solve_reads_per_iter": 14 / 6,
    "armijo_trials_per_iter": 8 / 6,
    "solve_read_wait_pct": 100 * 0.25 / 1.5,
    "solve_kernels_per_iter": 3 / 6,
    "solve_device_idle_pct": 100 * (1 - 0.85 / 1.5),
    "render_host_ms_per_frame": 5.0,
    "solve_fine_device_ms_per_iter": 1e3 * 0.1 / 2,  # the 16 x 16 level: k3 busy 0.1 s, 2 iterations
}


def _reading(trace=True):
    tr = vm_trace.Trace(DEVICE, [], (9.0, 16.0)) if trace else None
    return vm_run.Reading({}, {}, [], tr)


def _reader(name):
    return importlib.import_module(f"vmbench.metrics.{name}").read


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_a_hand_built_log(name, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(LOG))
    assert _reader(name)(_reading()) == pytest.approx(EXPECTED[name], rel=1e-6)


@pytest.mark.parametrize("name", READERS)
def test_reader_without_spans_or_trace_gives_none(name, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert _reader(name)(_reading()) is None
    monkeypatch.setattr(profiling, "spans", lambda: list(LOG))
    no_trace = _reader(name)(_reading(trace=False))
    assert (no_trace is None) == (name in ("solve_kernels_per_iter", "solve_device_idle_pct",
                                           "solve_fine_device_ms_per_iter"))
    monkeypatch.delattr(profiling, "spans")  # a program that keeps no log
    assert _reader(name)(_reading()) is None
