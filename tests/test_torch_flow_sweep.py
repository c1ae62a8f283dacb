"""Kernel 5, the flows' Horn-Schunck Jacobi sweep, on the CPU.

- ``kernels.flow.hs_sweep_plain`` applied ``flow_iters`` times is, bit for
  bit, the eager loop that ``video.flow._hs_level`` ran before the kernel
  (a frozen copy below), and so is the wrapper writing into two buffers in
  turn; batches of 1 and 3 and ragged shapes down to one row or column;
- ``_hs_level`` on CPU tensors is bitwise the frozen level and launches
  nothing;
- each pyramid level opens one ``flow.level`` span with its shape, batch
  and sweeps, and no ``fused_sweeps`` counter on the CPU; a level counts
  each launch of kernel 5 there;
- ``vmbench``'s ``flows_fused_sweeps_pct`` reads a hand-built log.

The kernel itself runs only on the card: ``chip_smoke.py`` holds it bitwise
to the plain version there.
"""

import importlib

import numpy as np
import pytest
import torch

from videomorphing_tpu_torch.config import VideoParams
from videomorphing_tpu_torch.kernels import flow as kf
from videomorphing_tpu_torch.ops.pyramid import pyramid_shapes
from videomorphing_tpu_torch.ops.windows import edge_shifts
from videomorphing_tpu_torch.utils import profiling
from videomorphing_tpu_torch.utils.synthetic import make_clips
from videomorphing_tpu_torch.video import flow as tf

torch.set_num_threads(2)
SHAPES = [(17, 30, 1), (17, 30, 3), (1, 5, 1), (1, 5, 3), (5, 1, 1), (5, 1, 3), (17, 30, None)]


def _frozen_level(a, b, u, vp):
    """``video.flow._hs_level`` as it was before kernel 5: the Jacobi loop
    in eager operations."""
    h, w = a.shape[0], a.shape[1]
    g = tf._grid_like(h, w, u)
    alpha2 = vp.flow_alpha * vp.flow_alpha

    def navg(f):
        up, dn, lf, rt = edge_shifts(f)
        return 0.25 * (up + dn + lf + rt)

    for _ in range(vp.flow_warps):
        u_w = u
        bw = tf._warp_gray(b, g + u_w, vp)
        it = bw - a
        iy, ix = tf._deriv(bw)
        denom = alpha2 + ix * ix + iy * iy
        grad = torch.stack([iy, ix], -1)
        ut = u_w
        for _ in range(vp.flow_iters):
            ua = navg(ut)
            diff = ua - u_w
            resid = (it + ix * diff[..., 1] + iy * diff[..., 0]) / denom
            ut = ua - grad * resid[..., None]
        u = u_w + torch.clamp(ut - u_w, -vp.flow_clamp, vp.flow_clamp)
    return u


def _lead(h, w, nb):
    return (h, w) if nb is None else (h, w, nb)


def _sweep_inputs(h, w, nb, seed):
    rng = np.random.default_rng(seed)
    lead = _lead(h, w, nb)
    t = lambda x: torch.from_numpy(np.asarray(x, dtype=np.float32))
    ix, iy = t(20.0 * rng.standard_normal(lead)), t(20.0 * rng.standard_normal(lead))
    return dict(ut=t(rng.standard_normal(lead + (2,))), u_w=t(rng.standard_normal(lead + (2,))),
                it=t(30.0 * rng.standard_normal(lead)), ix=ix, iy=iy, denom=100.0 + ix * ix + iy * iy)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_sweeps_are_the_frozen_loop(shape):
    x = _sweep_inputs(*shape, seed=sum(s or 0 for s in shape))
    vp = VideoParams()
    u_w, it, ix, iy, denom = x["u_w"], x["it"], x["ix"], x["iy"], x["denom"]
    grad = torch.stack([iy, ix], -1)
    ref = x["ut"]
    for _ in range(vp.flow_iters):
        up, dn, lf, rt = edge_shifts(ref)
        ua = 0.25 * (up + dn + lf + rt)
        diff = ua - u_w
        resid = (it + ix * diff[..., 1] + iy * diff[..., 0]) / denom
        ref = ua - grad * resid[..., None]
    plain, wrapped = x["ut"], x["ut"]
    bufs = (torch.empty_like(u_w), torch.empty_like(u_w))
    for k in range(vp.flow_iters):
        plain = kf.hs_sweep_plain(plain, u_w, it, ix, iy, denom)
        wrapped = kf.hs_sweep(wrapped, u_w, it, ix, iy, denom, bufs[k % 2])
        assert wrapped is bufs[k % 2]
    assert torch.equal(plain, ref) and torch.equal(wrapped, ref)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_hs_level_is_the_frozen_level_and_launches_nothing(shape):
    h, w, nb = shape
    lead = _lead(h, w, nb)
    rng = np.random.default_rng(h * w + (nb or 0))
    t = lambda x: torch.from_numpy(np.asarray(x, dtype=np.float32))
    a, b = t(255.0 * rng.random(lead)), t(255.0 * rng.random(lead))
    u = t(0.3 * rng.standard_normal(lead + (2,)))
    vp = VideoParams(flow_iters=12)
    before = kf.hs_sweep.launches
    got = tf._hs_level(a, b, u, vp)
    assert kf.hs_sweep.launches == before
    assert torch.equal(got, _frozen_level(a, b, u, vp))


@pytest.mark.parametrize("robust", [False, True])
def test_each_level_opens_one_span(robust):
    t_len, h, w = 3, 24, 40
    clip = torch.from_numpy(make_clips(t_len, h, w, seed=2)[0])
    vp = VideoParams(flow_scale=1.0, flow_levels=3, flow_iters=8, flow_robust=robust)
    profiling.clear()
    with profiling.record_phases():
        tf.clip_flows(clip, vp)
    levels = [s for s in profiling.spans() if s.name == "flow.level"]
    profiling.clear()
    shapes = pyramid_shapes(h, w, 3)
    assert [(s.attrs["h"], s.attrs["w"]) for s in levels] == shapes[::-1]
    inner = max(vp.flow_iters // vp.flow_irls, 1) * vp.flow_irls if robust else vp.flow_iters
    assert all(s.attrs["batch"] == 2 * (t_len - 1) and s.attrs["sweeps"] == vp.flow_warps * inner for s in levels)
    assert all("fused_sweeps" not in s.counts for s in levels)


def test_level_counts_the_launched_sweeps(monkeypatch):
    real = kf.hs_sweep

    def launching(*args):  # the plain sweep, counted as a launch of kernel 5
        launching.launches += 1
        return real(*args)

    launching.launches = 0
    monkeypatch.setattr(kf, "hs_sweep", launching)
    clip = torch.from_numpy(make_clips(3, 24, 40, seed=3)[0])
    vp = VideoParams(flow_scale=1.0, flow_levels=3, flow_iters=8)
    profiling.clear()
    with profiling.record_phases():
        tf.clip_flows(clip, vp)
    levels = [s for s in profiling.spans() if s.name == "flow.level"]
    profiling.clear()
    assert len(levels) == 3 and launching.launches == 3 * vp.flow_warps * vp.flow_iters
    assert all(s.counts["fused_sweeps"] == s.attrs["sweeps"] for s in levels)


def test_hs_sweep_rejects_mismatched_shapes():
    x = _sweep_inputs(6, 7, 2, seed=1)
    args = (x["u_w"], x["it"], x["ix"], x["iy"], x["denom"])
    with pytest.raises(ValueError, match="expected flows"):
        kf.hs_sweep(x["ut"][..., :1], *args, torch.empty(6, 7, 2, 1))
    with pytest.raises(ValueError, match="expected flows"):
        kf.hs_sweep(x["ut"], *args, torch.empty(6, 7, 3, 2))
    with pytest.raises(ValueError, match="expected flows"):
        kf.hs_sweep(x["ut"][:, :, 0], *args, torch.empty(6, 7, 2))


def _level_span(id_, sweeps, counts):
    return profiling.SpanRecord("flow.level", id_ * 10**9, id_ * 10**9 + 10**6, id_, None, id_,
                                {"h": 8, "w": 8, "batch": 4, "sweeps": sweeps}, counts)


def test_flows_fused_sweeps_pct_reads_the_levels_counters(monkeypatch):
    read = importlib.import_module("vmbench.metrics.flows_fused_sweeps_pct").read
    log = [_level_span(1, 80, {"fused_sweeps": 80}), _level_span(2, 80, {}), _level_span(3, 40, {"fused_sweeps": 40})]
    monkeypatch.setattr(profiling, "spans", lambda: list(log))
    assert read(None) == pytest.approx(60.0)
    monkeypatch.setattr(profiling, "spans", lambda: [_level_span(1, 80, {}), _level_span(2, 80, {})])
    assert read(None) is None  # a program that runs every sweep eagerly
    monkeypatch.setattr(profiling, "spans", lambda: [_level_span(1, 0, {"fused_sweeps": 0})])
    assert read(None) is None
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert read(None) is None
    monkeypatch.delattr(profiling, "spans")  # a program that keeps no log
    assert read(None) is None
