"""The render's CUDA-graph dispatch (``synth/render.py``), on the CPU.

On the card ``render_frame`` replays a captured graph of its eager body,
which reads the time from a device vector of ``time_values``; chip_smoke.py
phase 21 holds the replays to the eager body bitwise there. Here:

- a product (and a select) with an entry of the time vector gives the
  bits of the same one with the Python number, in float32 and float64;
- the vector body renders bitwise the frozen Python-number formulation
  (``vmbench.reference.synth.render``, a copy of the render before the
  vector), at six times, with and without a bulge and confidences, and
  its ``with_aux`` residual too; ``render_clip`` returns that copy's
  frames;
- the key function separates every field it names;
- CPU inputs, and ``with_aux``, never reach the graph path;
- the dispatch through ``graphs.capture``, with the stand-ins of
  ``fake_cuda`` below (a "replay" runs the eager body on the graph's
  buffers): every call copies its inputs and time in, gives the eager
  frame, captures once per key into a pool of its own, counts its capture
  and replay in the ``render.frame`` span and advances kernel 4's counters
  by one frame's launches;
- ``graphs``: the one capture runs each step once, then captures them
  into one new pool, takes back every ``launches*`` counter the captures
  moved and holds the constants they read, and a replay reruns a step and
  advances its counters; ``kernels.COUNTED`` lists every wrapper that
  counts; the constant caches hand their tensors to an open collection,
  the LRU drops the least recently used before it makes an entry;
- each of the modules that use ``graphs`` imports first in a fresh
  interpreter (no import cycle through ``utils``);
- ``vmbench``'s ``render_graph_frames_pct`` reads a hand-built log, and
  gives None where no ``render.frame`` span carries the counter.
"""

import contextlib
import importlib
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from videomorphing_tpu_torch.config import SynthParams
from videomorphing_tpu_torch.kernels import flow as kf
from videomorphing_tpu_torch.kernels import sweep as ks
from videomorphing_tpu_torch.kernels import warp as kw
from videomorphing_tpu_torch.ops import poisson, pyramid
from videomorphing_tpu_torch.synth import render
from videomorphing_tpu_torch import graphs
from videomorphing_tpu_torch.utils import profiling
from vmbench.reference.config import SynthParams as RefSynthParams
from vmbench.reference.synth import render as ref_render

torch.set_num_threads(2)
H, W = 256, 272  # the quarter-resolution path inversion runs from 256 px up
TIMES = (0.0, 1.0 / 119.0, 0.25, 0.5, 0.7, 1.0)


def _inputs(seed=0, h=H, w=W):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    return dict(
        i0=t(rng.random((h, w, 3))), i1=t(rng.random((h, w, 3))),
        v=t(rng.standard_normal((h, w, 2)) * 6.0), b=t(rng.standard_normal((h, w, 2)) * 2.0),
        conf0=t(rng.random((h, w))), conf1=t(rng.random((h, w))),
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_time_entries_multiply_like_python_numbers(dtype):
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(4096)).to(dtype)
    for t in TIMES + (0.3, 1e-30):
        values = render.time_values(t)
        tv = render._time_vector(t, x)
        for entry, number in zip(tv.unbind(), values):
            assert entry.dim() == 0 and entry.dtype == dtype
            assert torch.equal(entry * x, number * x)
            assert torch.equal(torch.where(x > 0, x, entry), torch.where(x > 0, x, torch.full_like(x, number)))


@pytest.mark.parametrize("with_b", [False, True], ids=["no_bulge", "bulge"])
@pytest.mark.parametrize("with_conf", [False, True], ids=["no_conf", "conf"])
def test_vector_body_renders_the_python_number_frames(with_b, with_conf):
    x = _inputs()
    b = x["b"] if with_b else None
    conf = (x["conf0"], x["conf1"]) if with_conf else (None, None)
    for t in TIMES:
        got = render.render_frame(x["i0"], x["i1"], x["v"], b, t, SynthParams(), *conf)
        want = ref_render.render_frame(x["i0"], x["i1"], x["v"], b, t, RefSynthParams(), *conf)
        assert torch.equal(got, want), t
    got, aux = render.render_frame(x["i0"], x["i1"], x["v"], b, 0.3, SynthParams(), *conf, with_aux=True)
    want, ref_aux = ref_render.render_frame(x["i0"], x["i1"], x["v"], b, 0.3, RefSynthParams(), *conf,
                                            with_aux=True)
    assert torch.equal(got, want)
    for name in ("mask0", "mask1", "inv_residual"):
        assert torch.equal(getattr(aux, name), getattr(ref_aux, name)), name


def test_render_clip_returns_the_frames_of_before():
    x = _inputs(2, 128, 160)
    ts = np.linspace(0.0, 1.0, 5, dtype=np.float32)
    got = render.render_clip(x["i0"], x["i1"], x["v"], x["b"], ts, SynthParams())
    want = ref_render.render_clip(x["i0"], x["i1"], x["v"], x["b"], ts, RefSynthParams())
    assert got.shape == (5, 128, 160, 3) and torch.equal(got, want)
    with pytest.raises(ValueError):
        render.render_clip(x["i0"], x["i1"], x["v"], x["b"], [], SynthParams())


def _specs(h=1024, w=1024, c=3, dtype=torch.float32, with_b=True, with_conf=False):
    img = ((h, w, c), dtype)
    field = ((h, w, 2), dtype)
    conf = ((h, w), dtype) if with_conf else None
    return (img, img, field, field if with_b else None, conf, conf)


def test_frame_graph_key_separates_every_field():
    base = dict(device=torch.device("cuda", 0), stream=7, specs=_specs(), sp=SynthParams(),
                allow_tf32=False, matmul_precision="highest")
    variants = {
        "device": torch.device("cuda", 1),
        "stream": 8,
        "specs": [_specs(h=1080), _specs(w=1920), _specs(c=4), _specs(dtype=torch.float64),
                  _specs(with_b=False), _specs(with_conf=True)],
        "sp": [SynthParams(blend_screen_lambda=0.2), SynthParams(sampling="bicubic"),
               SynthParams(blend_mode="linear"), SynthParams(invert_iters=5), SynthParams(extend_levels=3)],
        "allow_tf32": True,
        "matmul_precision": "high",
    }
    key = render.frame_graph_key(**base)
    assert key == render.frame_graph_key(**dict(base)) and hash(key) == hash(render.frame_graph_key(**base))
    seen = {key}
    for field, values in variants.items():
        for value in values if isinstance(values, list) else [values]:
            other = render.frame_graph_key(**dict(base, **{field: value}))
            assert other != key, (field, value)
            seen.add(other)
    assert len(seen) == 1 + sum(len(v) if isinstance(v, list) else 1 for v in variants.values())


def test_cpu_inputs_never_reach_the_graph_path(monkeypatch):
    def no_graph(*args, **kwargs):
        raise AssertionError("a CPU frame reached the graph path")

    monkeypatch.setattr(render, "_replay", no_graph)
    monkeypatch.setattr(render, "_capture", no_graph)
    x = _inputs(3, 64, 80)
    for conf in ((None, None), (x["conf0"], x["conf1"]), (x["conf0"], None)):
        render.render_frame(x["i0"], x["i1"], x["v"], x["b"], 0.5, SynthParams(), *conf)
        render.render_frame(x["i0"], x["i1"], x["v"], None, 0.5, SynthParams(), *conf, with_aux=True)
    render.render_clip(x["i0"], x["i1"], x["v"], x["b"], [0.0, 1.0], SynthParams())
    inputs = (x["i0"], x["i1"], x["v"], x["b"], None, None)
    assert not render._replayable(inputs)
    assert not render._replayable(tuple(None if t is None else t.to("meta") for t in inputs))
    assert not render._replayable((x["i0"].numpy(), x["i1"], x["v"], None, None, None))
    assert render._graphs.keys() == []


class FakeGraph:
    """A stand-in for ``torch.cuda.CUDAGraph``. Work that runs while it
    captures sets ``FakeGraph.capturing[-1].rerun`` to what a replay does
    (a replay runs no Python, so it counts no launch); ``pool`` is the pool
    it captured into."""

    capturing = []

    def __init__(self):
        self.rerun = self.pool = None

    def capture_begin(self, pool=None):
        self.pool = pool
        FakeGraph.capturing.append(self)

    def capture_end(self):
        FakeGraph.capturing.pop()

    def replay(self):
        self.rerun()


@pytest.fixture
def fake_cuda(monkeypatch):
    """``torch.cuda`` replaced by what ``graphs.capture`` and the replays
    call: :class:`FakeGraph`, a new pool object per ``graph_pool_handle()``,
    one stream, no-op stream and device contexts. Yields ``FakeGraph``;
    ``test_torch_solver_graph.py`` imports both."""
    stream = types.SimpleNamespace(cuda_stream=0, wait_stream=lambda other: None)
    cuda = types.SimpleNamespace(CUDAGraph=FakeGraph, graph_pool_handle=object, Stream=lambda dev: stream,
                                 stream=lambda s: contextlib.nullcontext(), current_stream=lambda dev: stream,
                                 device=lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch, "cuda", cuda)
    yield FakeGraph
    FakeGraph.capturing.clear()


def test_capture_and_replay_bookkeeping(monkeypatch, fake_cuda):
    real = render._render_frame_eager
    sampler = kw.bilinear_sample

    def eager(*args):
        sampler.launches += 7  # as if the body launched kernel 4 seven times
        out = real(*args)
        if fake_cuda.capturing:
            fake_cuda.capturing[-1].rerun = lambda: out.copy_(real(*args))
        return out

    monkeypatch.setattr(render, "_render_frame_eager", eager)
    monkeypatch.setattr(render, "_replayable", lambda inputs: True)
    monkeypatch.setattr(render, "_graphs", graphs.LRU(render.GRAPHS_KEPT))
    monkeypatch.setattr(sampler, "launches", 0)
    monkeypatch.setattr(render.torch, "backends", types.SimpleNamespace(
        cuda=types.SimpleNamespace(matmul=types.SimpleNamespace(allow_tf32=False))))
    sp = SynthParams()
    counts, launches = [], []
    with profiling.record_phases():
        for seed, t in ((5, 0.0), (6, 0.5), (7, 1.0), (6, 0.25)):
            x = _inputs(seed, 64, 80)
            args = (x["i0"], x["i1"], x["v"], x["b"])
            with profiling.span("render.frame") as span:
                before = sampler.launches
                got = render.render_frame(*args, t, sp, x["conf0"], x["conf1"])
                launches.append(sampler.launches - before)
            counts.append(span.counts)
            want = real(*args, render._time_vector(t, x["v"]), sp, x["conf0"], x["conf1"], False)
            assert torch.equal(got, want), (seed, t)
            x["i0"].add_(1.0)  # a later call must not see this: the buffers are copies
    assert counts == [{"graph_captures": 1, "graph_replays": 1}] + [{"graph_replays": 1}] * 3
    assert launches == [14, 7, 7, 7]  # the capture's own 7 are not counted: nothing ran
    assert len(render._graphs.keys()) == 1
    entry = render._graphs.get(render._graphs.keys()[0], None)
    assert entry.graph.launches == {"frame": ((sampler, "launches", 7),)}
    assert entry.graph.constants and all(isinstance(c, torch.Tensor) for c in entry.graph.constants)
    render.render_frame(*args, 0.5, sp)  # without the confidences: a key of its own
    render.render_frame(*args, 0.5, sp, with_aux=True)
    assert len(render._graphs.keys()) == 2
    pools = [render._graphs.get(k, None).graph.graphs["frame"].pool for k in render._graphs.keys()]
    assert pools[0] is not pools[1]  # a pool a frame graph


class _Wrapper:
    """A kernel wrapper's launch counters."""

    def __init__(self):
        self.launches = self.launches_bf16 = self.launches_wide = 0


def test_capture_takes_the_launches_back_and_replay_adds_them(fake_cuda):
    fp, bf = _Wrapper(), _Wrapper()
    out = torch.zeros(3)
    cached = graphs.constant_cache(4)(lambda n: torch.arange(float(n)))

    def step(name, bumps, value):
        def run():
            for fn, k, n in bumps:
                setattr(fn, k, getattr(fn, k) + n)
            taps = cached(3)
            if fake_cuda.capturing:
                fake_cuda.capturing[-1].rerun = lambda: out.add_(value * taps)
            return name
        return run

    steps = {"a": step("a", ((fp, "launches", 2), (bf, "launches_bf16", 1), (bf, "launches_wide", 1)), 1.0),
             ("b", 0): step("b", ((fp, "launches", 1),), 10.0), "c": step("c", (), 0.0)}
    got = graphs.capture(steps, "cuda:0", (fp, bf))
    # the warm-up ran each step once and counts; the captures ran nothing
    assert (fp.launches, bf.launches, bf.launches_bf16, bf.launches_wide) == (3, 0, 1, 1)
    assert got.outputs == {"a": "a", ("b", 0): "b", "c": "c"}
    assert got.launches == {"a": ((fp, "launches", 2), (bf, "launches_bf16", 1), (bf, "launches_wide", 1)),
                            ("b", 0): ((fp, "launches", 1),), "c": ()}
    assert len({g.pool for g in got.graphs.values()}) == 1 and got.graphs["a"].pool is not None
    assert len(got.constants) == 3 and all(c is cached(3) for c in got.constants)  # one a captured step
    got.replay("a")
    got.replay(("b", 0))
    got.replay("a")
    assert torch.equal(out, torch.tensor([0.0, 12.0, 24.0]))
    assert (fp.launches, bf.launches, bf.launches_bf16, bf.launches_wide) == (8, 0, 3, 3)
    got.replay("c")
    assert (fp.launches, bf.launches_bf16) == (8, 3)
    assert graphs.capture({"d": step("d", (), 0.0)}, "cuda:0", ()).graphs["d"].pool is not got.graphs["a"].pool


def test_counted_lists_every_counting_kernel_wrapper():
    from videomorphing_tpu_torch import kernels

    wrappers = {fn for mod in (ks, kw, kf) for fn in vars(mod).values() if callable(fn) and hasattr(fn, "launches")}
    assert set(kernels.COUNTED) == wrappers and len(kernels.COUNTED) == len(wrappers) == 9


def test_one_confidence_alone_is_ignored_as_before():
    x = _inputs(4, 64, 80)
    alone = render.render_frame(x["i0"], x["i1"], x["v"], x["b"], 0.4, SynthParams(), x["conf0"], None)
    none = render.render_frame(x["i0"], x["i1"], x["v"], x["b"], 0.4, SynthParams())
    assert torch.equal(alone, none)


def test_constant_caches_hand_their_tensors_to_an_open_collection():
    poisson._dct_mat.cache_clear()
    pyramid._resize_weights.cache_clear()
    cpu = torch.device("cpu")
    outside = poisson._dct_mat(8, torch.float32, cpu)
    with graphs.collect_constants() as got:
        hit = poisson._dct_mat(8, torch.float32, cpu)
        miss = pyramid._resize_weights(8, 16, cpu)
        with graphs.collect_constants() as inner:
            poisson._dct_mat(4, torch.float32, cpu)
        again = pyramid._resize_weights(8, 16, cpu)
    assert hit is outside and again is miss
    assert [id(t) for t in got] == [id(hit), id(miss), id(again)] and len(inner) == 1
    assert poisson._dct_mat.cache_info().hits >= 1 and pyramid._resize_weights.cache_info().currsize == 1
    poisson._dct_mat(16, torch.float32, cpu)  # no collection open: nothing kept
    assert len(got) == 3


def test_lru_drops_the_least_recently_used_before_it_makes_an_entry():
    lru = graphs.LRU(2)
    made = []

    def make(key):
        def f():
            made.append((key, lru.keys()))
            return {"key": key}
        return f

    a = lru.get("a", make("a"))
    lru.get("b", make("b"))
    assert lru.get("a", make("a")) is a
    lru.get("c", make("c"))
    assert lru.keys() == ["a", "c"]
    assert made == [("a", []), ("b", ["a"]), ("c", ["a"])]  # "b" was dropped before "c" was made
    with pytest.raises(RuntimeError):
        lru.get("d", lambda: (_ for _ in ()).throw(RuntimeError("capture failed")))
    assert lru.keys() == ["c"]
    lru.clear()
    assert lru.keys() == []


@pytest.mark.parametrize("module", ["kernels", "kernels.build", "ops", "ops.poisson", "utils", "synth.render"])
def test_module_imports_first_in_a_fresh_interpreter(module):
    root = Path(__file__).resolve().parents[1]
    done = subprocess.run([sys.executable, "-c", f"import videomorphing_tpu_torch.{module}"], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr[-2000:]


def _frame_span(id_, counts):
    return profiling.SpanRecord("render.frame", id_ * 10**9, id_ * 10**9 + 4_000_000, id_, None, id_, {}, counts)


def test_render_graph_frames_pct_reads_the_frames_counters(monkeypatch):
    read = importlib.import_module("vmbench.metrics.render_graph_frames_pct").read
    log = [_frame_span(1, {"graph_captures": 1, "graph_replays": 1}), _frame_span(2, {"graph_replays": 1}),
           _frame_span(3, {}), _frame_span(4, {"graph_replays": 1})]
    monkeypatch.setattr(profiling, "spans", lambda: list(log))
    assert read(None) == pytest.approx(75.0)
    monkeypatch.setattr(profiling, "spans", lambda: [_frame_span(1, {}), _frame_span(2, {})])
    assert read(None) is None  # a program that renders every frame eagerly
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert read(None) is None
    monkeypatch.delattr(profiling, "spans")  # a program that keeps no log
    assert read(None) is None
