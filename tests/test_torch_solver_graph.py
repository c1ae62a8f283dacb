"""The level solver's CUDA-graph dispatch (``solver/descent.py``), on the CPU.

On the card each step of ``make_level_solver`` between two reads replays a
captured graph of the eager step; chip_smoke.py phase 22 holds the replays
to the eager loop bitwise there. Here:

- the restructured loop (one read an iteration, the masks made once a
  level, the steps in place on the level's buffers) gives bitwise the field
  and the ``LevelStats`` of the frozen loop before it
  (``vmbench.reference.solver.descent``), history included: 1, 2 and 4
  colours, the re-warp's median on and off, a re-warp every iteration and
  every 8, no iteration, a level whose backtracks run out and one that
  stops on the stall rule;
- the per-level masks are ``boundary_mask`` and ``color_mask``;
- the key function separates every field it names, and the fields that
  only steer the host (``relin_every``, the line search's) share a key;
- CPU inputs never reach the graph path;
- the dispatch through ``graphs.capture``, with the stand-ins of
  ``test_torch_render_graph.fake_cuda`` (a "replay" reruns the step on
  the level's buffers): a level captures once per key, its steps into one
  pool, each call copies its field and data in and returns a copy, the span counts
  ``graph_iters``, ``armijo_trials`` and ``reads`` as it should, and the
  kernels' launch counters advance by one replay's launches;
- the LRU keeps every level of a 4K pyramid, and the video's cold levels
  with its warm one;
- the window's taps reach an open constant collection;
- ``vmbench``'s ``solve_graph_iters_pct`` reads a hand-built log, and gives
  None where no ``solve.level`` span carries the counter.
"""

import dataclasses
import importlib
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from videomorphing_tpu_torch import graphs
from videomorphing_tpu_torch.config import MorphParams, VideoParams
from videomorphing_tpu_torch.kernels import sweep as ks
from videomorphing_tpu_torch.kernels import warp as kw
from videomorphing_tpu_torch.ops.pyramid import auto_n_levels, pyramid_shapes
from videomorphing_tpu_torch.solver import descent
from videomorphing_tpu_torch.solver.energy import make_level_data
from videomorphing_tpu_torch.utils import profiling
from videomorphing_tpu_torch.video.pipeline import warm_level_count
from vmbench.reference.config import MorphParams as RefMorphParams
from vmbench.reference.solver import descent as ref_descent
from vmbench.reference.solver.energy import make_level_data as ref_level_data
from test_torch_render_graph import fake_cuda  # noqa: F401  (the fixture)

torch.set_num_threads(2)
H, W = 36, 44


def _level(seed=0, h=H, w=W, shift=2):
    """A textured pair moved by ``shift`` columns, sparse point weights, a
    small random start."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    i0 = rng.random((h, w, 3))
    i1 = np.roll(i0, shift, axis=1)
    ui_w = (rng.random((h, w, 1)) > 0.97) * 1.0
    ui_v = rng.standard_normal((h, w, 2))
    v0 = rng.standard_normal((h, w, 2)) * 0.3
    return t(v0), [t(i0), t(i1), t(ui_w), t(ui_v)]


def _same_stats(got, want):
    assert (got.e0, got.e_final, got.iters, got.step) == (want.e0, want.e_final, want.iters, want.step)
    assert got.energy_history.shape == want.energy_history.shape
    assert torch.equal(got.energy_history.isnan(), want.energy_history.isnan())
    assert torch.equal(got.energy_history.nan_to_num(), want.energy_history.nan_to_num())


CASES = {
    "colors1": (dict(n_colors=1), 20),
    "colors2": (dict(), 20),
    "colors4": (dict(n_colors=4), 20),
    "no_median": (dict(relin_median=False), 20),
    "relin1": (dict(relin_every=1), 12),
    "relin1_colors4_no_median": (dict(relin_every=1, n_colors=4, relin_median=False), 10),
    "zero_iters": (dict(), 0),
    "backtracks_run_out": (dict(init_step=1e4, max_backtracks=1), 6),
    "stall": (dict(tol=10.0), 40),
}


@pytest.mark.parametrize("case", list(CASES))
def test_loop_gives_the_frozen_loop_s_bits(case):
    overrides, n_iters = CASES[case]
    v0, arrs = _level(1)
    v, st = descent.make_level_solver(MorphParams(**overrides), n_iters)(v0, make_level_data(*arrs))
    v_ref, st_ref = ref_descent.make_level_solver(RefMorphParams(**overrides), n_iters)(v0, ref_level_data(*arrs))
    assert torch.equal(v, v_ref)
    _same_stats(st, st_ref)
    assert torch.equal(v0, _level(1)[0])  # the input is left as it was
    if case == "backtracks_run_out":
        assert st.energy_history[0] == st.e0  # the first step was not taken
    if case == "stall":
        assert 0 < st.iters < n_iters
    if n_iters:
        assert st.e_final < st.e0 or case == "backtracks_run_out"


@pytest.mark.parametrize("n_colors", [1, 2, 4])
@pytest.mark.parametrize("hw", [(5, 7), (8, 8), (17, 30)])
def test_level_masks_are_the_boundary_and_colour_masks(n_colors, hw):
    bmask, cmasks = descent.level_masks(*hw, n_colors)
    assert torch.equal(bmask, descent.boundary_mask(*hw))
    assert len(cmasks) == n_colors
    for c, m in enumerate(cmasks):
        assert torch.equal(m, descent.color_mask(*hw, c, n_colors))
    assert torch.equal(sum(cmasks), torch.ones(hw + (1,)))
    with pytest.raises(ValueError):
        descent.level_masks(*hw, 3)


def _specs(h=1024, w=1024, c=3, v_dtype=torch.float32, map_dtype=torch.float32):
    return (((h, w, 2), v_dtype), ((h, w, c), torch.float32), ((h, w, c), torch.float32),
            ((h, w, 1), map_dtype), ((h, w, 2), map_dtype), ((h, w, 1), map_dtype), ((h, w, 2), map_dtype))


_OTHER_VALUES = {"ssim_window": 7, "ssim_sigma": 1.5, "ssim_c1": 2e-4, "ssim_c2": 1e-3, "ssim_use_luminance": False,
                 "lambda_tps": 0.01, "gamma_ui": 25.0, "beta_tc": 1.0, "precond_eps": 1e-2, "fold_margin": 0.4,
                 "n_colors": 4, "relin_median": False}


def test_level_graph_key_separates_every_field():
    base = dict(device=torch.device("cuda", 0), stream=7, specs=_specs(), pack=torch.float32, p=MorphParams())
    variants = {
        "device": [torch.device("cuda", 1)],
        "stream": [8],
        "specs": [_specs(h=540), _specs(w=960), _specs(c=4), _specs(v_dtype=torch.float64),
                  _specs(map_dtype=torch.bfloat16)],
        "pack": [torch.bfloat16],
        "p": [dataclasses.replace(MorphParams(), **{f: _OTHER_VALUES[f]}) for f in descent.GRAPH_FIELDS],
    }
    assert set(_OTHER_VALUES) == set(descent.GRAPH_FIELDS)
    key = descent.level_graph_key(**base)
    assert key == descent.level_graph_key(**dict(base)) and hash(key) == hash(descent.level_graph_key(**base))
    seen = {key}
    for field, values in variants.items():
        for value in values:
            other = descent.level_graph_key(**dict(base, **{field: value}))
            assert other != key, (field, value)
            seen.add(other)
    assert len(seen) == 1 + sum(len(v) for v in variants.values())
    # what only steers the host's loop shares the graphs
    host = dict(relin_every=1, init_step=0.5, step_grow=2.0, step_shrink=0.25, max_backtracks=3, armijo_c=1e-3,
                min_step=1e-6, tol=1e-5, iters_coarse=50, iters_fine=5, n_levels=3, ui_sigma=2.0)
    assert descent.level_graph_key(**dict(base, p=MorphParams(**host))) == key


def test_cpu_inputs_never_reach_the_graph_path(monkeypatch):
    def no_graph(*args, **kwargs):
        raise AssertionError("a CPU level reached the graph path")

    monkeypatch.setattr(descent, "_replaying", no_graph)
    monkeypatch.setattr(descent, "_capture_level", no_graph)
    monkeypatch.setattr(descent, "_graphs", graphs.LRU(descent.LEVEL_GRAPHS_KEPT))
    v0, arrs = _level(2, 16, 20)
    data = make_level_data(*arrs)
    for n in (0, 3):
        descent.make_level_solver(MorphParams(), n)(v0, data)
    assert not graphs.replayable((v0,) + tuple(data))
    assert not graphs.replayable([x.to("meta") for x in (v0,) + tuple(data)])
    assert not graphs.replayable([v0.numpy()] + list(data)) and not graphs.replayable([])
    assert descent._graphs.keys() == []


# the launches each step makes on the card, which the plain versions do not count
STEP_LAUNCHES = {"_warp_step": ((kw.halfway_warp, 1),), "_median_step": (),
                 "_iterate_step": ((ks.sweep_grad, 1), (ks.sweep_energy, 1)), "_trial_step": ((ks.sweep_energy, 1),)}


def _stand_ins(monkeypatch, fake_graph):
    """The CUDA calls of the graph path replaced (``fake_cuda``): a step run
    while a stand-in graph captures is also what that graph reruns, and
    each step counts the launches it would make (and reads the window's
    taps, as a launch does)."""
    def counted(real, launches):
        def step(*args):
            real(*args)
            for fn, n in launches:
                fn.launches += n
            if launches:
                ks.window_taps(args[1], "cpu")
            if fake_graph.capturing:
                fake_graph.capturing[-1].rerun = lambda: real(*args)  # a replay runs no Python: counts nothing

        return step

    for name, launches in STEP_LAUNCHES.items():
        monkeypatch.setattr(descent, name, counted(getattr(descent, name), launches))
    for fn in (kw.halfway_warp, ks.sweep_grad, ks.sweep_energy):
        monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(descent, "replayable", lambda tensors: True)
    monkeypatch.setattr(descent, "_graphs", graphs.LRU(descent.LEVEL_GRAPHS_KEPT))


def _counters():
    return [kw.halfway_warp.launches, ks.sweep_grad.launches, ks.sweep_energy.launches]


def test_capture_and_replay_bookkeeping(monkeypatch, fake_cuda):
    p = MorphParams(relin_every=3)
    n_iters = 10
    want = {}
    for seed in (5, 6):
        v0, arrs = _level(seed)
        want[seed] = ref_descent.make_level_solver(RefMorphParams(relin_every=3), n_iters)(v0, ref_level_data(*arrs))
    _stand_ins(monkeypatch, fake_cuda)
    solve = descent.make_level_solver(p, n_iters)
    spans, advanced, fields = [], [], []
    with profiling.record_phases():
        for seed in (5, 6, 5):
            v0, arrs = _level(seed)
            before = _counters()
            v, st = solve(v0, make_level_data(*arrs))
            advanced.append([a - b for a, b in zip(_counters(), before)])
            spans.append([s for s in profiling.spans() if s.name == "solve.level"][-1])
            _same_stats(st, want[seed][1])
            fields.append(v)
            v0.add_(1.0)
            arrs[0].add_(1.0)  # a later call must not see these: the buffers are copies
    # each field returned is a copy that the later calls leave alone
    for seed, v in zip((5, 6, 5), fields):
        assert torch.equal(v, want[seed][0]), seed
    assert len(descent._graphs.keys()) == 1
    entry = descent._graphs.get(descent._graphs.keys()[0], None).graphs
    assert set(entry.graphs) == {"warp", "median", ("iterate", 0), ("iterate", 1), "trial"}
    assert len({g.pool for g in entry.graphs.values()}) == 1  # one pool a level
    assert entry.launches["warp"] == ((kw.halfway_warp, "launches", 1),)
    assert entry.launches[("iterate", 1)] == ((ks.sweep_grad, "launches", 1), (ks.sweep_energy, "launches", 1))
    assert entry.launches["trial"] == ((ks.sweep_energy, "launches", 1),) and entry.launches["median"] == ()
    assert entry.constants and all(c is ks.window_taps(p, "cpu") for c in entry.constants)
    # the warm-up before the capture runs every step once: one warp, two iterations, a trial
    warm_up = [1, 2, 3]
    for k, (span, moved) in enumerate(zip(spans, advanced)):
        iters, trials = span.attrs["iters"], span.counts["armijo_trials"]
        assert iters == n_iters and trials >= iters
        assert span.counts["graph_iters"] == iters and span.counts["reads"] == trials
        assert span.counts.get("graph_captures", 0) == (k == 0)
        replayed = [math.ceil(iters / p.relin_every), iters, trials]
        assert moved == [r + (w if k == 0 else 0) for r, w in zip(replayed, warm_up)], k
    # another shape, and parameters that only steer the host, on their own keys or not
    v0, arrs = _level(7, 24, 28)
    descent.make_level_solver(p, 4)(v0, make_level_data(*arrs))
    descent.make_level_solver(dataclasses.replace(p, relin_every=5, tol=1e-6), 4)(v0, make_level_data(*arrs))
    assert len(descent._graphs.keys()) == 2
    descent.make_level_solver(dataclasses.replace(p, n_colors=1), 4)(v0, make_level_data(*arrs))
    assert len(descent._graphs.keys()) == 3


def test_graph_path_without_the_median_captures_none(monkeypatch, fake_cuda):
    _stand_ins(monkeypatch, fake_cuda)
    p = MorphParams(relin_median=False, n_colors=4, relin_every=1)
    v0, arrs = _level(8)
    v, st = descent.make_level_solver(p, 9)(v0, make_level_data(*arrs))
    v_ref, st_ref = ref_descent.make_level_solver(RefMorphParams(relin_median=False, n_colors=4, relin_every=1), 9)(
        v0, ref_level_data(*arrs))
    assert torch.equal(v, v_ref)
    _same_stats(st, st_ref)
    entry = descent._graphs.get(descent._graphs.keys()[0], None)
    assert set(entry.graphs.graphs) == {"warp", "trial"} | {("iterate", c) for c in range(4)}


def _level_keys(hw, n_levels, p=MorphParams()):
    return [descent.level_graph_key(torch.device("cuda", 0), 0, _specs(h, w), torch.float32, p)
            for h, w in pyramid_shapes(*hw, n_levels)]


def test_lru_keeps_every_level_of_a_4k_pyramid_and_of_the_video():
    shapes_4k = _level_keys((2160, 3840), auto_n_levels(2160, 3840, MorphParams().min_level_size))
    assert len(shapes_4k) == 8
    vp = VideoParams()
    cold = _level_keys((1080, 1920), auto_n_levels(1080, 1920, MorphParams().min_level_size))
    warm_p = dataclasses.replace(MorphParams(), relin_every=vp.warm_relin_every or MorphParams().relin_every)
    warm = _level_keys((1080, 1920), warm_level_count((1080, 1920), vp), warm_p)
    for keys in (shapes_4k, cold + warm):
        lru, made = graphs.LRU(descent.LEVEL_GRAPHS_KEPT), []
        for _ in range(3):  # three morphs: only the first captures
            for key in keys:
                lru.get(key, lambda key=key: made.append(key) or key)
        assert made == list(dict.fromkeys(keys))


def test_window_taps_reach_an_open_collection():
    p = MorphParams(ssim_window=9, ssim_sigma=1.5)
    taps = ks.window_taps(p, "cpu")
    with graphs.collect_constants() as got:
        assert ks.window_taps(p, torch.device("cpu")) is taps
    assert len(got) == 1 and got[0] is taps


@pytest.mark.parametrize("module", ["solver.descent", "kernels.sweep", "solver"])
def test_module_imports_first_in_a_fresh_interpreter(module):
    root = Path(__file__).resolve().parents[1]
    done = subprocess.run([sys.executable, "-c", f"import videomorphing_tpu_torch.{module}"], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr[-2000:]


def _level_span(id_, iters, counts):
    return profiling.SpanRecord("solve.level", id_ * 10**9, id_ * 10**9 + 10**6, id_, None, id_,
                                {"h": 8, "w": 8, "iters": iters}, counts)


def test_solve_graph_iters_pct_reads_the_levels_counters(monkeypatch):
    read = importlib.import_module("vmbench.metrics.solve_graph_iters_pct").read
    log = [_level_span(1, 30, {"graph_iters": 30, "reads": 40}), _level_span(2, 10, {"reads": 12}),
           _level_span(3, 0, {"reads": 1}), _level_span(4, 60, {"graph_iters": 60, "graph_captures": 1})]
    monkeypatch.setattr(profiling, "spans", lambda: list(log))
    assert read(None) == pytest.approx(90.0)
    monkeypatch.setattr(profiling, "spans", lambda: [_level_span(1, 5, {"reads": 6}), _level_span(2, 3, {})])
    assert read(None) is None  # a program that runs every iteration eagerly
    monkeypatch.setattr(profiling, "spans", lambda: [_level_span(1, 0, {"graph_iters": 0})])
    assert read(None) is None
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert read(None) is None
    monkeypatch.delattr(profiling, "spans")  # a program that keeps no log
    assert read(None) is None
