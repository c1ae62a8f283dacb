"""The sweep kernels' strip forms as the solver counts them and the
benchmark reads them, on the CPU.

- ``kernels.sweep.strip`` names the strip form where ``kernel_name`` does,
  at every radius the kernels take (R = 0-24);
- ``descent.descend`` tags each ``solve.level`` span with the kernels'
  ``radius`` and, for a level whose sweeps launch the card's kernels,
  counts ``strip_iters`` on every iteration whose gradient pass runs kernel
  1's strip (windows 7-15) and ``strip_trials`` on every Armijo trial
  whose energy pass runs kernel 2's strip (windows 9-15); a stub level
  stands in for the card. The CPU's level solvers, single-device and
  row-sharded, count neither;
- ``vmbench``'s ``sweep_strip_roofline_pct`` reads a hand-built log and
  trace to a pinned number, and None without the counters, without strip
  launches, without a trace or without a log.
"""

import importlib

import numpy as np
import pytest
import torch

from videomorphing_tpu_torch.config import MorphParams
from videomorphing_tpu_torch.kernels import sweep as ks
from videomorphing_tpu_torch.parallel.mesh import make_mesh
from videomorphing_tpu_torch.parallel.spatial import make_spatial_level_solver
from videomorphing_tpu_torch.solver import descent
from videomorphing_tpu_torch.solver.energy import make_level_data
from videomorphing_tpu_torch.utils import profiling
from vmbench import run as vm_run
from vmbench import trace as vm_trace

torch.set_num_threads(1)
f32 = np.float32


@pytest.mark.parametrize("radius", range(25))
def test_strip_agrees_with_kernel_name(radius):
    for with_grad in (True, False):
        assert ks.strip(with_grad, radius) == ("_strip_kernel<" in ks.kernel_name(with_grad, radius))
    assert ks.strip(True, radius) == (3 <= radius <= 7)
    assert ks.strip(False, radius) == (4 <= radius <= 7)


class _StubLevel:
    """A level for ``descend`` that does no work: energies that fall each
    iteration, and every third first trial rejected once, so that it
    backtracks."""

    def __init__(self, on_card: bool):
        self.on_card, self.k = on_card, 0

    def relin(self, median):
        pass

    def iterate(self, color, alpha):
        self.k += 1
        e = f32(1.0 / self.k)
        return e, f32(-1.0), (e + f32(1.0)) if self.k % 3 == 0 else e * f32(0.9)

    def backtrack(self, alpha):
        return f32(0.0)

    def accept(self):
        pass

    def energy(self):
        return f32(1.0)

    def field(self):
        return torch.zeros((4, 4, 2))


def _levels(run) -> tuple:
    profiling.clear()
    try:
        with profiling.record_phases():
            out = run()
        return out, [s for s in profiling.spans() if s.name == "solve.level"]
    finally:
        profiling.clear()


@pytest.mark.parametrize("on_card", [True, False])
@pytest.mark.parametrize("window,grad_strip,energy_strip", [(11, True, True), (7, True, False), (5, False, False)])
def test_descend_counts_the_strip_passes(window, grad_strip, energy_strip, on_card):
    p = MorphParams(ssim_window=window, n_colors=2, relin_every=4)
    (_, st), levels = _levels(lambda: descent.descend(lambda: _StubLevel(on_card), p, 9, 4, 4))
    assert len(levels) == 1
    span = levels[0]
    assert st.iters == span.attrs["iters"] == 9 and span.attrs["radius"] == window // 2
    assert span.counts["armijo_trials"] == 9 + 3
    assert span.counts.get("strip_iters", 0) == (9 if on_card and grad_strip else 0)
    assert span.counts.get("strip_trials", 0) == (12 if on_card and energy_strip else 0)


def _level(h=48, w=40, seed=3):
    rng = np.random.default_rng(seed)
    i0 = torch.from_numpy(rng.random((h, w, 3), dtype=np.float32))
    i1 = torch.roll(i0, 2, dims=1)
    return torch.zeros((h, w, 2)), make_level_data(i0, i1, torch.zeros((h, w, 1)), torch.zeros((h, w, 2)))


@pytest.mark.parametrize("solver", ["one device", "row blocks"])
def test_cpu_level_solvers_count_no_strips(solver):
    p = MorphParams(ssim_window=11, ssim_sigma=1.5)
    solve = (descent.make_level_solver(p, 5) if solver == "one device"
             else make_spatial_level_solver(p, 5, make_mesh((2,), ("y",), devices=["cpu"] * 2)))
    (_, st), levels = _levels(lambda: solve(*_level()))
    assert len(levels) == 1 and st.iters > 0
    assert levels[0].attrs["radius"] == 5 and levels[0].counts["armijo_trials"] >= st.iters
    assert "strip_iters" not in levels[0].counts and "strip_trials" not in levels[0].counts


# --- sweep_strip_roofline_pct on a hand-built log and trace ----------------------

NS = 1_000_000_000


def _span(id_, h, w, counts, radius=5):
    return profiling.SpanRecord("solve.level", id_ * NS, id_ * NS + NS // 2, id_, None, id_,
                                {"h": h, "w": w, "n_iters": 30, "radius": radius, "iters": 9}, counts)


LOG = [_span(1, 64, 128, {"armijo_trials": 14, "strip_iters": 10, "strip_trials": 12}),
       _span(2, 32, 64, {"armijo_trials": 6, "strip_iters": 4, "strip_trials": 5}),
       _span(3, 16, 16, {"armijo_trials": 9})]  # a level that launched no kernel counts no strips
STRIPS = [(1.0, 1.001, "void sweep_grad_strip_kernel<5, float>(Args, VmSweepScalars)"),
          (1.001, 1.0011, "void sweep_reduce_kernel(float const*, int, float*, VmSweepScalars)"),
          (1.002, 1.0025, "void sweep_energy_strip_kernel<5, float>(Args, VmSweepScalars)"),
          (1.0025, 1.00255, "void sweep_reduce_kernel(float const*, int, float*, VmSweepScalars)"),
          (1.005, 1.0052, "void sweep_grad_strip_kernel<5, float>(Args, VmSweepScalars)"),
          (1.0052, 1.00522, "void sweep_reduce_kernel(float const*, int, float*, VmSweepScalars)")]
OTHERS = [(1.003, 1.004, "void sweep_grad_kernel<2, float>(Args, VmSweepScalars)"),
          (1.004, 1.0041, "void sweep_reduce_kernel(float const*, int, float*, VmSweepScalars)"),
          (1.006, 1.007, "Memcpy DtoH (Device -> Pageable)")]
CONFIG = {"channels": 3, "morph": {"ssim_window": 11}}


def _reading(device):
    return vm_run.Reading(CONFIG, {}, [], vm_trace.Trace(device, [], (0.5, 2.0)))


def _read(monkeypatch, log, reading):
    monkeypatch.setattr(profiling, "spans", lambda: list(log))
    return importlib.import_module("vmbench.metrics.sweep_strip_roofline_pct").read(reading)


def test_sweep_strip_roofline_pct_pinned(monkeypatch):
    # the least time: (10 x 8192 + 4 x 2048) gradient pixels at 128 B and
    # (12 x 8192 + 5 x 2048) energy pixels at 112 B, both bound by bytes at
    # 3.35 TB/s; over the strips' 1.87 ms with their reduces
    want = 100 * (90112 * 128 + 108544 * 112) / 3.35e12 / 1.87e-3
    assert _read(monkeypatch, LOG, _reading(STRIPS + OTHERS)) == pytest.approx(want, rel=1e-6)
    assert want == pytest.approx(0.37818284, rel=1e-6)


@pytest.mark.parametrize("case", ["no counters", "no strip launches", "no trace", "no log"])
def test_sweep_strip_roofline_pct_none(monkeypatch, case):
    log, reading = LOG, _reading(STRIPS + OTHERS)
    if case == "no counters":
        log = [_span(1, 64, 128, {"armijo_trials": 14, "graph_iters": 9})]
    elif case == "no strip launches":
        reading = _reading(OTHERS)
    elif case == "no trace":
        reading = vm_run.Reading(CONFIG, {}, [], None)
    if case == "no log":
        monkeypatch.delattr(profiling, "spans")  # a program that keeps no log
        assert importlib.import_module("vmbench.metrics.sweep_strip_roofline_pct").read(reading) is None
    else:
        assert _read(monkeypatch, log, reading) is None
