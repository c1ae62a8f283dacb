"""Kernels 6 and 7, the robust flow's IRLS step, on the CPU.

- ``kernels.flow.irls_setup_plain`` followed by ``inner`` applications of
  ``irls_sweep_plain`` is, bit for bit, the eager IRLS step that
  ``video.flow._robust_level`` ran before the kernels (a frozen copy below),
  and so are the wrappers writing into ``out`` (the sweeps into two buffers
  in turn); batches of 1 and 3, shapes down to one row or column, odd
  widths and a flow without a batch axis;
- the wrappers raise on mismatched shapes; ``out`` overlapping an input is
  found, and no sweep of a level writes over the flow it reads;
- ``_robust_level`` on CPU tensors is bitwise the frozen level, launches
  nothing and leaves no ``fused_irls_steps`` counter; a level counts each
  launch of kernel 6 there;
- ``vmbench``'s ``irls_fused_steps_pct`` reads a hand-built log, and None
  without the counter.

The kernels themselves run only on the card: ``chip_smoke.py`` holds them
bitwise to the plain versions there.
"""

import importlib

import numpy as np
import pytest
import torch

from videomorphing_tpu_torch.config import VideoParams
from videomorphing_tpu_torch.kernels import flow as kf
from videomorphing_tpu_torch.ops.windows import edge_shifts
from videomorphing_tpu_torch.utils import profiling
from videomorphing_tpu_torch.utils.synthetic import make_clips
from videomorphing_tpu_torch.video import flow as tf

torch.set_num_threads(2)
SHAPES = [(17, 30, 1), (17, 30, 3), (17, 31, 3), (1, 5, 1), (1, 5, 3), (5, 1, 1), (5, 1, 3), (1, 1, 2),
          (17, 31, None)]
VP = VideoParams(flow_robust=True)
CONSTS = dict(alpha2=VP.flow_alpha_robust ** 2, eps2=VP.flow_eps ** 2, eps2_s=VP.flow_eps_s ** 2, gamma=VP.flow_gamma)


def _frozen_step(ut, u_w, chans, inner, alpha2, eps2, eps2_s, gamma):
    """One IRLS step of ``video.flow._robust_level`` as it was before
    kernels 6 and 7: ``chans`` the three (residual, d/dy, d/dx) triples,
    weighted 1, ``gamma``, ``gamma``."""
    chans = [(it_c, gy_c, gx_c, cw) for (it_c, gy_c, gx_c), cw in zip(chans, (1.0, gamma, gamma))]
    du = ut - u_w
    ws = []
    for n in edge_shifts(ut):
        d = n - ut
        ws.append(1.0 / torch.sqrt(torch.sum(d * d, -1) + eps2_s))
    wsum = ws[0] + ws[1] + ws[2] + ws[3]
    s = alpha2 * wsum * 0.25

    r2_sum = torch.zeros_like(s)
    for it_c, gy_c, gx_c, cw in chans:
        r = it_c + gy_c * du[..., 0] + gx_c * du[..., 1]
        r2_sum = r2_sum + cw * r * r
    w_pix = 1.0 / torch.sqrt(r2_sum + eps2)

    a11 = s
    a12 = torch.zeros_like(s)
    a22 = s
    b1 = torch.zeros_like(s)
    b2 = torch.zeros_like(s)
    for it_c, gy_c, gx_c, cw in chans:
        wc = cw * w_pix
        a11 = a11 + wc * gy_c * gy_c
        a12 = a12 + wc * gy_c * gx_c
        a22 = a22 + wc * gx_c * gx_c
        c = it_c - gy_c * u_w[..., 0] - gx_c * u_w[..., 1]
        b1 = b1 - wc * gy_c * c
        b2 = b2 - wc * gx_c * c
    det = a11 * a22 - a12 * a12

    for _ in range(inner):
        un_u, un_d, un_l, un_r = edge_shifts(ut)
        ua = (
            ws[0][..., None] * un_u + ws[1][..., None] * un_d
            + ws[2][..., None] * un_l + ws[3][..., None] * un_r
        ) / wsum[..., None]
        r1 = s * ua[..., 0] + b1
        r2 = s * ua[..., 1] + b2
        uy = (a22 * r1 - a12 * r2) / det
        ux = (a11 * r2 - a12 * r1) / det
        ut = 0.5 * ut + 0.5 * torch.stack([uy, ux], -1)
    return ut


def _frozen_level(a, b, u, vp):
    """``video.flow._robust_level`` as it was before kernels 6 and 7."""
    h, w = a.shape[0], a.shape[1]
    g = tf._grid_like(h, w, u)
    consts = dict(alpha2=vp.flow_alpha_robust ** 2, eps2=vp.flow_eps ** 2, eps2_s=vp.flow_eps_s ** 2,
                  gamma=vp.flow_gamma)
    ay, ax = tf._deriv(a)
    for _ in range(vp.flow_warps):
        u_w = u
        bw = tf._warp_gray(b, g + u_w, vp)
        bwy, bwx = tf._deriv(bw)
        byy, byx = tf._deriv(bwy)
        bxy, bxx = tf._deriv(bwx)
        chans = ((bw - a, bwy, bwx), (bwy - ay, byy, byx), (bwx - ax, bxy, bxx))
        inner = max(vp.flow_iters // vp.flow_irls, 1)
        ut = u_w
        for _ in range(vp.flow_irls):
            ut = _frozen_step(ut, u_w, chans, inner, **consts)
        u = u_w + torch.clamp(ut - u_w, -vp.flow_clamp, vp.flow_clamp)
    return u


def _lead(h, w, nb):
    return (h, w) if nb is None else (h, w, nb)


def _step_inputs(h, w, nb, seed):
    """A flow, its warp's start and the nine channel maps at the scale of
    grey images in [0, 255] and their derivatives."""
    rng = np.random.default_rng(seed)
    lead = _lead(h, w, nb)
    t = lambda x: torch.from_numpy(np.asarray(x, dtype=np.float32))
    maps = t(np.stack([s * rng.standard_normal(lead) for s in (30.0, 20.0, 20.0) * 3]))
    return t(rng.standard_normal(lead + (2,))), t(rng.standard_normal(lead + (2,))), maps


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_irls_step_is_the_frozen_step(shape):
    ut, u_w, maps = _step_inputs(*shape, seed=sum(s or 0 for s in shape))
    inner = 8
    ref = _frozen_step(ut, u_w, (maps[0:3], maps[3:6], maps[6:9]), inner, **CONSTS)
    coef = kf.irls_setup_plain(ut, u_w, maps, **CONSTS)
    assert coef.shape == maps.shape
    plain = ut
    for _ in range(inner):
        plain = kf.irls_sweep_plain(plain, coef, CONSTS["alpha2"])
    out = torch.empty_like(maps)
    got = kf.irls_setup(ut, u_w, maps, *CONSTS.values(), out)
    assert got is out and torch.equal(out, coef)
    bufs = (torch.empty_like(ut), torch.empty_like(ut))
    wrapped = ut
    for k in range(inner):
        wrapped = kf.irls_sweep(wrapped, out, CONSTS["alpha2"], bufs[k % 2])
        assert wrapped is bufs[k % 2]
    assert torch.equal(plain, ref) and torch.equal(wrapped, ref)
    assert float((ref - ut).abs().max()) > 0.0


@pytest.mark.parametrize("shape", [(17, 31, 3), (1, 5, None)], ids=lambda s: "x".join(map(str, s)))
def test_irls_maps_is_the_stack_the_step_reads(shape):
    ut, u_w, maps = _step_inputs(*shape, seed=7)
    chans = (maps[0:3].clone(), maps[3:6].clone(), maps[6:9].clone())
    stacked = kf.irls_maps(*[tuple(c) for c in chans])
    assert stacked.shape == maps.shape and stacked.is_contiguous()
    for c in range(3):
        for k in range(3):
            assert torch.equal(stacked[3 * c + k], chans[c][k])
    ref = _frozen_step(ut, u_w, chans, 2, **CONSTS)
    got = ut
    coef = kf.irls_setup_plain(ut, u_w, stacked, **CONSTS)
    for _ in range(2):
        got = kf.irls_sweep_plain(got, coef, CONSTS["alpha2"])
    assert torch.equal(got, ref)


@pytest.mark.parametrize("shape", [(17, 30, 3), (1, 5, 3), (5, 1, 1), (17, 31, None)],
                         ids=lambda s: "x".join(map(str, s)))
def test_robust_level_is_the_frozen_level_and_launches_nothing(shape):
    h, w, nb = shape
    lead = _lead(h, w, nb)
    rng = np.random.default_rng(h * w + (nb or 0))
    t = lambda x: torch.from_numpy(np.asarray(x, dtype=np.float32))
    a, b = t(255.0 * rng.random(lead)), t(255.0 * rng.random(lead))
    u = t(0.3 * rng.standard_normal(lead + (2,)))
    vp = VideoParams(flow_robust=True, flow_iters=12, flow_irls=4)
    before = (kf.irls_setup.launches, kf.irls_sweep.launches)
    profiling.clear()
    with profiling.record_phases(), profiling.span("flow.level"):
        got = tf._robust_level(a, b, u, vp)
    level = [s for s in profiling.spans() if s.name == "flow.level"]
    profiling.clear()
    assert (kf.irls_setup.launches, kf.irls_sweep.launches) == before
    assert len(level) == 1 and level[0].counts == {"irls_steps": vp.flow_warps * vp.flow_irls}
    assert torch.equal(got, _frozen_level(a, b, u, vp))


@pytest.mark.parametrize("iters,irls", [(3, 3), (9, 3), (40, 5)])
def test_each_sweep_writes_apart_from_the_flow_it_reads(monkeypatch, iters, irls):
    """The kernel reads its neighbours' flow while writing: on the card the
    wrapper raises on an ``out`` that overlaps ``ut``, here the level is
    held to it, one sweep a step or several, odd or even."""
    real = kf.irls_sweep
    calls = []

    def apart(ut, coef, alpha2, out):
        kf._check_apart(out, ut, coef)
        calls.append(out.data_ptr())
        return real(ut, coef, alpha2, out)

    monkeypatch.setattr(kf, "irls_sweep", apart)
    h, w, nb = 9, 13, 2
    rng = np.random.default_rng(5)
    t = lambda x: torch.from_numpy(np.asarray(x, dtype=np.float32))
    a, b = t(255.0 * rng.random((h, w, nb))), t(255.0 * rng.random((h, w, nb)))
    u = t(0.3 * rng.standard_normal((h, w, nb, 2)))
    vp = VideoParams(flow_robust=True, flow_iters=iters, flow_irls=irls)
    got = tf._robust_level(a, b, u, vp)
    assert len(calls) == tf._sweeps(vp) and len(set(calls)) == 2
    monkeypatch.setattr(kf, "irls_sweep", real)
    assert torch.equal(got, _frozen_level(a, b, u, vp))


def test_level_counts_the_launched_irls_steps(monkeypatch):
    real = kf.irls_setup

    def launching(*args):  # the plain set-up, counted as a launch of kernel 6
        launching.launches += 1
        return real(*args)

    launching.launches = 0
    monkeypatch.setattr(kf, "irls_setup", launching)
    clip = torch.from_numpy(make_clips(3, 24, 40, seed=3)[0])
    vp = VideoParams(flow_scale=1.0, flow_levels=3, flow_iters=8, flow_irls=4, flow_robust=True)
    profiling.clear()
    with profiling.record_phases():
        tf.clip_flows(clip, vp)
    levels = [s for s in profiling.spans() if s.name == "flow.level"]
    profiling.clear()
    assert len(levels) == 3 and launching.launches == 3 * vp.flow_warps * vp.flow_irls
    assert all(s.counts["fused_irls_steps"] == s.counts["irls_steps"] == vp.flow_warps * vp.flow_irls
               for s in levels)


def test_irls_wrappers_reject_mismatched_shapes():
    ut, u_w, maps = _step_inputs(6, 7, 2, seed=1)
    c = tuple(CONSTS.values())
    with pytest.raises(ValueError, match="expected flows"):
        kf.irls_setup(ut, u_w, maps, *c, torch.empty(9, 6, 7, 3))
    with pytest.raises(ValueError, match="expected flows"):
        kf.irls_setup(ut, u_w, maps[:8], *c, torch.empty(8, 6, 7, 2))
    with pytest.raises(ValueError, match="expected flows"):
        kf.irls_setup(ut[..., :1], u_w[..., :1], maps, *c, torch.empty_like(maps))
    with pytest.raises(ValueError, match="not the shape of ut"):
        kf.irls_setup(ut, u_w[:, :6], maps, *c, torch.empty_like(maps))
    coef = kf.irls_setup_plain(ut, u_w, maps, *c)
    with pytest.raises(ValueError, match="expected flows"):
        kf.irls_sweep(ut, coef, c[0], torch.empty(6, 7, 3, 2))
    with pytest.raises(ValueError, match="expected flows"):
        kf.irls_sweep(ut, coef[:, :5], c[0], torch.empty_like(ut))
    with pytest.raises(ValueError, match="expected flows"):
        kf.irls_sweep(ut[:, :, 0], coef, c[0], torch.empty(6, 7, 2))


def test_out_overlapping_an_input_is_found():
    buf = torch.zeros(64)
    kf._check_apart(buf[:32], buf[32:])
    with pytest.raises(ValueError, match="overlaps"):
        kf._check_apart(buf[:32], buf[16:48])
    with pytest.raises(ValueError, match="overlaps"):
        kf._check_apart(buf[20:40], buf[:8], buf[:32])


def _level_span(id_, counts):
    return profiling.SpanRecord("flow.level", id_ * 10**9, id_ * 10**9 + 10**6, id_, None, id_,
                                {"h": 8, "w": 8, "batch": 4, "sweeps": 80}, counts)


def test_irls_fused_steps_pct_reads_the_levels_counters(monkeypatch):
    read = importlib.import_module("vmbench.metrics.irls_fused_steps_pct").read
    log = [_level_span(1, {"irls_steps": 10, "fused_irls_steps": 10}), _level_span(2, {"irls_steps": 10}),
           _level_span(3, {"irls_steps": 20, "fused_irls_steps": 20})]
    monkeypatch.setattr(profiling, "spans", lambda: list(log))
    assert read(None) == pytest.approx(75.0)
    monkeypatch.setattr(profiling, "spans", lambda: [_level_span(1, {"irls_steps": 10})])
    assert read(None) is None  # a program that runs every IRLS step eagerly
    monkeypatch.setattr(profiling, "spans", lambda: [_level_span(1, {"fused_sweeps": 80})])
    assert read(None) is None  # Horn-Schunck levels
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert read(None) is None
    monkeypatch.delattr(profiling, "spans")  # a program that keeps no log
    assert read(None) is None
