"""The window and percentile arithmetic, the idle union of a made-up trace,
and the per-layer readers on made-up spans, counts and kernels."""

import pytest

from vmbench import roofline, stats
from vmbench.metrics import (
    device_idle_pct,
    flows_ms_per_clip,
    kernels_per_morph,
    render_ms_per_frame,
    solve_ms_per_morph,
    solver_iters_per_s_per_mpix,
    sweep_device_ms_per_morph,
    sweep_grad_roofline_pct,
)
from vmbench.run import Reading, Record
from vmbench.trace import Trace, innermost


def test_window_rate_counts_whole_morphs_over_the_window():
    morphs = [(10.0, 11.0, 16), (11.0, 12.5, 16), (12.5, 13.0, 16)]
    rate, window, frames = stats.window_rate(morphs)
    assert (window, frames) == (3.0, 48)
    assert rate == pytest.approx(16.0)
    with pytest.raises(ValueError):
        stats.window_rate([])


def test_percentile_and_spread():
    vals = [float(v) for v in range(1, 11)]
    assert stats.percentile(vals, 90) == pytest.approx(9.1)
    assert stats.percentile(vals, 50) == pytest.approx(5.5)
    assert stats.percentile([2.5], 90) == 2.5
    q1, med, q3 = 2.75, 5.5, 8.25  # statistics.quantiles(1..10, n=4), exclusive method
    assert stats.spread(vals) == pytest.approx((q3 - q1) / med)


def test_union_and_gaps():
    merged = stats.union([(5, 7), (0, 2), (1, 3), (6, 9), (12, 20)], 0.5, 15)
    assert merged == [(0.5, 3), (5, 9), (12, 15)]
    assert stats.covered(merged) == pytest.approx(9.5)
    assert stats.gaps(merged, 0.5, 15) == [(3, 5), (9, 12)]
    assert stats.gaps([], 0, 1) == [(0, 1)]


def _trace():
    host = [(0.0, 10.0, "solve"), (1.0, 2.0, "aten::item"), (3.0, 4.0, "aten::add"),
            (5.0, 9.0, "render"), (6.0, 7.0, "aten::mul")]
    device = [
        (0.5, 1.0, "void (anonymous namespace)::sweep_grad_kernel<2, float>(float const*)"),
        (1.0, 1.5, "(anonymous namespace)::sweep_reduce_kernel(float const*, int)"),
        (2.5, 3.0, "void (anonymous namespace)::sweep_energy_kernel<2, float>(float const*)"),
        (3.0, 3.5, "(anonymous namespace)::sweep_reduce_kernel(float const*, int)"),
        (3.5, 3.6, "Memcpy DtoH (Device -> Pinned)"),
        (4.0, 6.5, "void at::native::vectorized_elementwise_kernel<4>(int)"),
        (11.0, 12.0, "void late_kernel(int)"),
    ]
    return Trace(device, host, (0.0, 10.0))


def test_trace_busy_idle_and_breakdown():
    t = _trace()
    assert t.busy == [(0.5, 1.5), (2.5, 3.6), (4.0, 6.5)]
    assert t.busy_s == pytest.approx(4.6)
    assert t.window_s == 10.0
    assert len(t.kernels()) == 5  # the copy and the kernel after the window are left out
    gaps = dict((k, v) for k, v in t.idle_gaps())
    assert gaps == pytest.approx({"render": 3.5, "solve > aten::item": 1.0, "solve": 0.5,
                                  "solve > aten::add": 0.4})
    ops = t.device_ops()
    assert ops[0] == ["at::native::vectorized_elementwise_kernel<4>", pytest.approx(2.5)]
    assert ["sweep_reduce_kernel", pytest.approx(1.0)] in ops
    assert ["Memcpy DtoH (Device -> Pinned)", pytest.approx(0.1)] in ops


def test_innermost_nested_ranges():
    ev = [(0, 10, "a"), (1, 5, "b"), (2, 3, "c"), (6, 7, "d")]
    assert innermost(ev, [0.5, 2.5, 4, 6.5, 8, 11]) == ["a", "c", "b", "d", "a", None]


def _reading(trace, config=None, records=None):
    config = config or {"height": 1024, "width": 1024, "channels": 3, "morph": {"ssim_window": 5}}
    records = records or [
        Record(0, 0.0, 1.0, 16, {"iters": 60, "level_iters": [[512, 512, 40], [1024, 1024, 20]]},
               {"solve": 0.75, "render": 0.25}),
        Record(1, 1.0, 2.0, 16, {"iters": 50, "level_iters": [[512, 512, 30], [1024, 1024, 20]]},
               {"solve": 0.65, "render": 0.35}),
    ]
    return Reading(config, {}, records, trace)


def test_pair_readers_on_made_up_spans_and_counts():
    r = _reading(_trace())
    assert solve_ms_per_morph.read(r) == pytest.approx(700.0)
    assert render_ms_per_frame.read(r) == pytest.approx(1e3 * 0.6 / 32)
    assert solver_iters_per_s_per_mpix.read(r) == pytest.approx(110 / 1.4 / 1.048576)
    assert flows_ms_per_clip.read(r) is None
    assert kernels_per_morph.read(r) == pytest.approx(2.5)
    assert device_idle_pct.read(r) == pytest.approx(54.0)
    # kernels 1-2 with their reduces: 0.5 + 0.5 + 0.5 + 0.5 s over 2 morphs
    assert sweep_device_ms_per_morph.read(r) == pytest.approx(1000.0)


def test_roofline_reader_from_made_up_level_stats():
    r = _reading(_trace())
    need = 70 * roofline.sweep_grad_bound_s(512, 512, 3, 5) + 40 * roofline.sweep_grad_bound_s(1024, 1024, 3, 5)
    # kernel 1: its launch and the reduce that follows it, 1.0 s of device time
    assert sweep_grad_roofline_pct.read(r) == pytest.approx(100.0 * need / 1.0)


def test_readers_return_none_where_nothing_is_read():
    video = [Record(0, 0.0, 3.0, 30, {"iters": 800},
                    {"flows": 1.0, "tracking": 0.25, "cold_solve": 0.5, "warm_loop": 0.5, "render": 0.6})]
    r = _reading(None, records=video)
    for mod in (sweep_grad_roofline_pct, sweep_device_ms_per_morph, device_idle_pct, kernels_per_morph):
        assert mod.read(r) is None
    assert flows_ms_per_clip.read(r) == pytest.approx(1250.0)
    assert solve_ms_per_morph.read(r) == pytest.approx(1000.0)
    empty = _reading(Trace([], [(0.0, 1.0, "solve")], (0.0, 1.0)), records=video)
    assert sweep_device_ms_per_morph.read(empty) is None
    assert sweep_grad_roofline_pct.read(empty) is None
    assert kernels_per_morph.read(empty) is None
