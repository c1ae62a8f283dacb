"""The robust (Brox-class) flow of the port on the CPU, and what the
benchmark's ``video_480p.stressor30`` cell reads of it.

- ``video.flow.clip_flows`` with ``flow_robust=True`` is, bit for bit, the
  benchmark's plain reference (``vmbench.reference.video.flow``) on even
  and odd widths, one and several pyramid levels, two seeds: the two run
  the same float32 operations in the same order, and the warp's plain
  sampler on the CPU is the reference's;
- ``vmbench.stressor.make_takes`` gives the port's ``make_stressor`` clips
  and disk-centre points, bit for bit, at the same seed;
- each IRLS step of a robust level opens one ``flow.irls`` span under its
  ``flow.level`` span, with the level's shape and batch and its inner
  sweeps, which add up to ``_sweeps(vp)`` a level; the level counts its
  ``irls_steps``; Horn-Schunck levels open none and count none; nothing is
  logged with tracing off, and tracing leaves the flows' bits alone;
- the readers ``irls_kernels_per_sweep`` and ``irls_device_idle_pct`` on a
  hand-built log and trace, and None without the spans or the trace.
"""

import importlib

import numpy as np
import pytest
import torch

from vmbench import run as vm_run
from vmbench import stressor as vm_stressor
from vmbench import trace as vm_trace
from vmbench.reference.config import VideoParams as RefVideoParams
from vmbench.reference.video import flow as ref_flow
from videomorphing_tpu_torch.config import VideoParams
from videomorphing_tpu_torch.ops.pyramid import pyramid_shapes
from videomorphing_tpu_torch.utils import profiling
from videomorphing_tpu_torch.utils.stressor import make_stressor
from videomorphing_tpu_torch.utils.synthetic import make_clips
from videomorphing_tpu_torch.video import flow as tf

torch.set_num_threads(2)
SHAPES = [(4, 36, 44), (4, 36, 45)]
SETTINGS = {
    "defaults": {},  # flow_scale 0.5, the levels auto_n_levels gives
    "full_scale_3_levels": dict(flow_scale=1.0, flow_levels=3, flow_iters=12, flow_irls=4),
}


def _params(cls, over):
    return cls(flow_robust=True, **over)


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_robust_clip_flows_are_the_reference(shape, seed, setting):
    clip = vm_stressor.make_takes(*shape, seed=seed, device="cpu")[0]
    fwd, bwd = tf.clip_flows(clip, _params(VideoParams, SETTINGS[setting]))
    ref_fwd, ref_bwd = ref_flow.clip_flows(clip, _params(RefVideoParams, SETTINGS[setting]))
    assert fwd.shape == (shape[0] - 1, shape[1], shape[2], 2)
    assert torch.equal(fwd, ref_fwd) and torch.equal(bwd, ref_bwd)
    assert float(fwd.abs().max()) > 0.0


@pytest.mark.parametrize("seed", [0, 7, 2**40 + 3])
@pytest.mark.parametrize("shape", [(4, 36, 44), (3, 30, 45)], ids=lambda s: "x".join(map(str, s)))
def test_stressor_takes_are_the_programs(shape, seed):
    clip_a, clip_b, points = vm_stressor.make_takes(*shape, seed=seed, device="cpu")
    case = make_stressor(*shape, seed=seed, device="cpu")
    assert clip_a.dtype == torch.float32 and clip_a.shape == shape + (3,)
    assert torch.equal(clip_a, case.clip_a) and torch.equal(clip_b, case.clip_b)
    assert points.dtype == np.float32 and np.array_equal(points, case.points)


def test_stressor_takes_follow_the_seed():
    a = vm_stressor.make_takes(3, 24, 32, seed=5, device="cpu")
    b = vm_stressor.make_takes(3, 24, 32, seed=5, device="cpu")
    c = vm_stressor.make_takes(3, 24, 32, seed=6, device="cpu")
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    assert np.array_equal(a[2], c[2])  # the disk's path is the formula's, not the seed's


def _logged_flows(vp, seed=2):
    clip = torch.from_numpy(make_clips(3, 24, 40, seed=seed)[0])
    profiling.clear()
    with profiling.record_phases():
        out = tf.clip_flows(clip, vp)
    log = profiling.spans()
    profiling.clear()
    return out, log


@pytest.mark.parametrize("irls,iters", [(5, 40), (3, 8), (4, 3)])
def test_each_irls_step_opens_one_span(irls, iters):
    vp = VideoParams(flow_scale=1.0, flow_levels=3, flow_robust=True, flow_irls=irls, flow_iters=iters)
    _, log = _logged_flows(vp)
    levels = [s for s in log if s.name == "flow.level"]
    steps = [s for s in log if s.name == "flow.irls"]
    assert len(levels) == 3 and len(steps) == 3 * vp.flow_warps * irls
    by_id = {s.id: s for s in log}
    inner = max(iters // irls, 1)
    for s in steps:
        up = by_id[s.parent]
        assert up.name == "flow.level" and up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns
        assert (s.attrs["h"], s.attrs["w"], s.attrs["batch"]) == (up.attrs["h"], up.attrs["w"], up.attrs["batch"])
        assert s.attrs["sweeps"] == inner and s.counts == {}
    for level in levels:
        mine = [s for s in steps if s.parent == level.id]
        assert sum(s.attrs["sweeps"] for s in mine) == tf._sweeps(vp) == level.attrs["sweeps"]
        assert level.counts == {"irls_steps": vp.flow_warps * irls}
    assert [(s.attrs["h"], s.attrs["w"]) for s in levels] == pyramid_shapes(24, 40, 3)[::-1]


def test_horn_schunck_levels_open_no_irls_span():
    _, log = _logged_flows(VideoParams(flow_scale=1.0, flow_levels=3, flow_iters=8))
    assert [s.name for s in log if s.name.startswith("flow.")] == ["flow.level"] * 3
    assert not any("irls_steps" in s.counts for s in log)


@pytest.mark.parametrize("robust", [False, True])
def test_tracing_off_logs_nothing_and_tracing_moves_no_bit(robust):
    vp = VideoParams(flow_scale=1.0, flow_levels=2, flow_iters=8, flow_robust=robust)
    clip = torch.from_numpy(make_clips(3, 24, 40, seed=4)[0])
    profiling.clear()
    off = tf.clip_flows(clip, vp)
    assert profiling.spans() == [] and profiling._stack == []
    on, log = _logged_flows(vp, seed=4)
    assert log and all(torch.equal(x, y) for x, y in zip(off, on))


NS = 10**9


def _rec(name, a, b, id_, parent=None, attrs=None, counts=None):
    return profiling.SpanRecord(name, int(a * NS), int(b * NS), id_, parent, 1 if parent else id_,
                                attrs or {}, counts or {})


LOG = [
    _rec("flow.irls", 10.0, 11.0, 2, 1, {"h": 8, "w": 8, "batch": 4, "sweeps": 8}),
    _rec("flow.irls", 11.0, 11.5, 3, 1, {"h": 8, "w": 8, "batch": 4, "sweeps": 8}),
    _rec("flow.level", 9.5, 12.0, 1, None, {"h": 8, "w": 8, "batch": 4, "sweeps": 16}, {"irls_steps": 2}),
    _rec("solve.level", 12.0, 13.0, 4, None, {"h": 8, "w": 8, "iters": 4}),
]
# a kernel before the steps (the warp's set-up), four inside, one after
DEVICE = [(9.6, 9.9, "k0"), (10.1, 10.3, "k1"), (10.5, 10.7, "k2"), (10.95, 11.2, "k3"),
          (11.3, 11.4, "Memcpy DtoH"), (11.45, 11.6, "k4"), (12.5, 12.6, "k5")]
EXPECTED = {
    "irls_kernels_per_sweep": 4 / 16,
    "irls_device_idle_pct": 100 * (1 - (0.2 + 0.2 + 0.25 + 0.1 + 0.05) / 1.5),
}


def _reading(trace=True):
    tr = vm_trace.Trace(DEVICE, [], (9.0, 14.0)) if trace else None
    return vm_run.Reading({}, {}, [], tr)


def _reader(name):
    return importlib.import_module(f"vmbench.metrics.{name}").read


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_a_hand_built_log(name, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(LOG))
    assert _reader(name)(_reading()) == pytest.approx(EXPECTED[name], rel=1e-6)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_without_spans_or_trace_gives_none(name, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: [s for s in LOG if s.name != "flow.irls"])
    assert _reader(name)(_reading()) is None  # Horn-Schunck flows, or a program without the span
    monkeypatch.setattr(profiling, "spans", lambda: list(LOG))
    assert _reader(name)(_reading(trace=False)) is None
    monkeypatch.delattr(profiling, "spans")  # a program that keeps no log
    assert _reader(name)(_reading()) is None
