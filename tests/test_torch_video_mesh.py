"""Port parity: the mesh video paths (``parallel/frames.py``,
``parallel/video_blocks.py``, ``video.flow.clip_flows_sharded`` and the
``mesh=`` of ``video.pipeline``).

The reference runs on ``make_mesh((n,), ("batch",))`` from the 8 virtual
CPU devices, the port on ``make_mesh((n,), devices=["cpu"] * n)``. One JAX
``solve_clip_fields`` at T = 4, 32 x 48 (module fixture) provides flows,
tracked points and fields; ``interop`` carries them across. Tolerances:

- the sharded flows against ``clip_flows``: 1e-5 (the same per-pair
  operations in other batches);
- the mesh render against the sequential render from identical fields:
  2e-5 (frames and bulges), as the reference's own test;
- the blocked solve against the reference's blocked solve from identical
  flows and tracked points: the same iteration count and the fields within
  5e-3 px, the warm-loop chain bound of ``test_torch_video_pipeline.py``
  (each block is a cold solve plus a chained warm loop);
- ``optimize_pairs_batched`` against the reference's: 1e-3 px, the pair
  solver's drift bound (``test_torch_solver.py``), and bitwise against the
  port's own ``optimize_pair`` per pair;
- ``api.morph_clips(mesh=)`` against the reference's with a mesh: frames
  within 2e-3 and fields within 5e-3 px, the end-to-end and chain bounds of
  ``test_torch_video_pipeline.py``;
- ``render_clip_sharded`` against the reference's: 1e-4, the pair render's
  bound, and bitwise against the port's ``render_clip``;
- ``render_video_frames_sharded(conf_flows=...)`` against the reference's
  on a 3-frame 40 x 56 clip pair and a 1-device mesh: frames and bulges
  within 1e-4, the pair render's bound, and bitwise against the port's
  own ``flows=`` route on the same flows.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from videomorphing_tpu import api as jax_api
from videomorphing_tpu.config import MorphParams as JaxMorphParams
from videomorphing_tpu.config import SynthParams as JaxSynthParams
from videomorphing_tpu.config import VideoParams as JaxVideoParams
from videomorphing_tpu.parallel import frames as jfr
from videomorphing_tpu.parallel.mesh import make_mesh as jax_make_mesh
from videomorphing_tpu.parallel.video_blocks import solve_clip_fields_blocked as jax_blocked
from videomorphing_tpu.video import pipeline as jp
from videomorphing_tpu_torch import api
from videomorphing_tpu_torch.config import MorphParams, SynthParams, VideoParams
from videomorphing_tpu_torch.interop import fields_from_numpy, flows_from_numpy
from videomorphing_tpu_torch.parallel import frames as tfr
from videomorphing_tpu_torch.parallel.mesh import make_mesh
from videomorphing_tpu_torch.parallel.video_blocks import solve_clip_fields_blocked
from videomorphing_tpu_torch.solver.ctf import optimize_pair
from videomorphing_tpu_torch.synth.render import render_clip
from videomorphing_tpu_torch.utils import profiling
from videomorphing_tpu_torch.video import flow as tf
from videomorphing_tpu_torch.video import pipeline as tp

torch.set_num_threads(2)
T_LEN, H, W = 4, 32, 48
JMP = JaxMorphParams(iters_coarse=8, iters_fine=4)
JVP = JaxVideoParams()
CHAIN_ATOL = 5e-3


def _port(p):
    cls = {JaxMorphParams: MorphParams, JaxSynthParams: SynthParams, JaxVideoParams: VideoParams}[type(p)]
    return cls(**dataclasses.asdict(p))


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _maxabs(a, b):
    a = np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor) else a, np.float64)
    b = np.asarray(b.detach().numpy() if isinstance(b, torch.Tensor) else b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)))


def _mesh(n):
    return make_mesh((n,), devices=["cpu"] * n)


@pytest.fixture(scope="module")
def clips():
    ca, cb = bench._make_clips(T_LEN, H, W, seed=0)
    pts = np.array(
        [[[H * 0.4, W * 0.45], [H * 0.4, W * 0.55]], [[H * 0.6, W * 0.45], [H * 0.6, W * 0.55]]],
        np.float32,
    )
    return ca, cb, pts


@pytest.fixture(scope="module")
def solved(clips):
    ca, cb, pts = clips
    fields, tracked, flows = jp.solve_clip_fields(jnp.asarray(ca), jnp.asarray(cb), jnp.asarray(pts), JMP, JVP)
    return np.asarray(fields), np.asarray(tracked), {k: np.asarray(v) for k, v in flows.items()}


@pytest.mark.parametrize("n_dev", [2, 3, 5])
def test_clip_flows_sharded_matches_clip_flows(clips, n_dev):
    """3 frame pairs over 2, 3 and 5 devices (padding, one each, more
    devices than pairs)."""
    clip = _t(clips[0])
    fwd, bwd = tf.clip_flows(clip, VideoParams())
    fwd_s, bwd_s = tf.clip_flows_sharded(clip, VideoParams(), _mesh(n_dev))
    assert fwd_s.shape == fwd.shape == (T_LEN - 1, H, W, 2) and bwd_s.shape == bwd.shape
    assert _maxabs(fwd, fwd_s) <= 1e-5 and _maxabs(bwd, bwd_s) <= 1e-5


@pytest.mark.parametrize("occlusion", [True, False])
def test_mesh_render_matches_sequential(clips, solved, occlusion):
    ca, cb, _ = clips
    fields, _, flows = solved
    sp = SynthParams(occlusion_weighting=occlusion)
    args = (_t(ca), _t(cb), fields_from_numpy(fields))
    seq = tp.render_video(*args, sp=sp, flows=flows_from_numpy(flows))
    with profiling.record_phases() as rec:
        shd = tp.render_video(*args, sp=sp, flows=flows_from_numpy(flows), mesh=_mesh(3))
    assert "render" in rec
    assert shd.frames.shape == (T_LEN, H, W, 3)
    assert _maxabs(seq.frames, shd.frames) <= 2e-5
    assert _maxabs(seq.bulges, shd.bulges) <= 2e-5


def test_mesh_render_one_frame_shares(clips, solved):
    """4 frames over 5 devices: one frame per share, the last share holds
    only the clip's last frame (its confidence reads the final pair) and
    the fifth device is idle."""
    ca, cb, _ = clips
    fields, _, flows = solved
    args = (_t(ca), _t(cb), fields_from_numpy(fields))
    seq = tp.render_video(*args, flows=flows_from_numpy(flows))
    shd = tp.render_video(*args, flows=flows_from_numpy(flows), mesh=_mesh(5))
    assert _maxabs(seq.frames, shd.frames) <= 2e-5
    assert _maxabs(seq.bulges, shd.bulges) <= 2e-5


def test_mesh_render_honors_caller_bulges(clips, solved):
    ca, cb, _ = clips
    fields = fields_from_numpy(solved[0])
    stored = torch.full((T_LEN, H, W, 2), 2.0)
    seq = tp.render_video(_t(ca), _t(cb), fields, bulges=stored)
    shd = tp.render_video(_t(ca), _t(cb), fields, bulges=stored, mesh=_mesh(2))
    assert _maxabs(seq.frames, shd.frames) <= 2e-5
    assert torch.equal(shd.bulges, stored)
    fresh = tp.render_video(_t(ca), _t(cb), fields, mesh=_mesh(2))
    assert _maxabs(fresh.frames, shd.frames) > 1e-3


def test_blocked_solve_matches_reference(clips, solved):
    """Two blocks of two frames from the reference's flows and tracked
    points: a cold head and one warm frame each."""
    ca, cb, _ = clips
    _, tracked, flows = solved
    ref, ref_iters = jax_blocked(
        jnp.asarray(ca), jnp.asarray(cb), jnp.asarray(tracked),
        {k: jnp.asarray(v) for k, v in flows.items()}, jax_make_mesh((2,), ("batch",)), JMP, JVP,
    )
    with profiling.record_phases() as rec:
        got, iters = solve_clip_fields_blocked(
            _t(ca), _t(cb), _t(tracked), flows_from_numpy(flows), _mesh(2), _port(JMP), _port(JVP)
        )
    assert iters == int(ref_iters)
    assert len(rec["warm_iters"]) == 2 and {"cold_solve", "warm_loop"} <= set(rec)
    assert _maxabs(ref, got) <= CHAIN_ATOL


def test_solve_clip_fields_mesh_pads_and_trims():
    """8 frames over 3 blocks: the clip pads to 9 with its last frame and
    the fields trim back; the blocked path runs (3 cold heads) and agrees
    with the reference's blocked solve on the same clip."""
    ca, cb = bench._make_clips(8, H, W, seed=2)
    mp = JaxMorphParams(iters_coarse=8, iters_fine=4)
    ref, _, _, ref_iters = jp.solve_clip_fields(
        jnp.asarray(ca), jnp.asarray(cb), None, mp, JVP, mesh=jax_make_mesh((3,), ("batch",)),
        return_stats=True,
    )
    with profiling.record_phases() as rec:
        got, tracked, flows, iters = tp.solve_clip_fields(
            _t(ca), _t(cb), None, _port(mp), VideoParams(), mesh=_mesh(3), return_stats=True
        )
    assert got.shape == (8, H, W, 2) and torch.isfinite(got).all()
    assert flows["fa_fwd"].shape == (7, H, W, 2) and tracked.shape == (8, 0, 2, 2)
    assert len(rec["warm_iters"]) == 6  # 3 blocks of 3 frames, 2 warm each
    assert iters == int(ref_iters)
    assert _maxabs(ref, got) <= CHAIN_ATOL


def test_optimize_pairs_batched_matches_reference():
    rng = np.random.default_rng(4)
    ca, _ = bench._make_clips(4, 32, 32, seed=3)
    i0s = ca + 0.05 * rng.random(ca.shape, dtype=np.float32)
    i1s = np.roll(i0s, 2, axis=2)
    mp = JaxMorphParams(n_levels=2, iters_coarse=8, iters_fine=4)
    ref = jfr.optimize_pairs_batched(jnp.asarray(i0s), jnp.asarray(i1s), jax_make_mesh((4,), ("batch",)), mp)
    got = tfr.optimize_pairs_batched(_t(i0s), _t(i1s), _mesh(4), _port(mp))
    assert got.shape == (4, 32, 32, 2)
    assert _maxabs(ref, got) <= 1e-3
    for k in range(4):
        assert torch.equal(got[k], optimize_pair(_t(i0s[k]), _t(i1s[k]), params=_port(mp)).v)


def test_render_clip_sharded_matches_reference(clips, solved):
    ca, cb, _ = clips
    v = solved[0][1]
    ts = np.linspace(0.0, 1.0, 7, dtype=np.float32)  # 7 times over 4 devices pads to 8
    sp = JaxSynthParams()
    ref = jfr.render_clip_sharded(jnp.asarray(ca[1]), jnp.asarray(cb[1]), jnp.asarray(v), None,
                                  jnp.asarray(ts), jax_make_mesh((4,), ("batch",)), sp)
    got = tfr.render_clip_sharded(_t(ca[1]), _t(cb[1]), _t(v), None, ts, _mesh(4), _port(sp))
    assert got.shape == (7, H, W, 3)
    assert _maxabs(ref, got) <= 1e-4
    assert torch.equal(got, render_clip(_t(ca[1]), _t(cb[1]), _t(v), None, ts, _port(sp)))


def test_morph_clips_with_mesh(clips):
    """``api.morph_clips(mesh=)`` end to end against the reference's
    ``morph_clips(mesh=)``; the first block is the sequential solve's first
    two frames, bitwise."""
    ca, cb, pts = clips
    ref = jax_api.morph_clips(ca, cb, pts, mp=JMP, mesh=jax_make_mesh((2,), ("batch",)))
    seq = api.morph_clips(ca, cb, pts, mp=_port(JMP), device="cpu")
    got = api.morph_clips(ca, cb, pts, mp=_port(JMP), mesh=_mesh(2), device="cpu")
    assert got.frames.shape == (T_LEN, H, W, 3) and torch.isfinite(got.frames).all()
    assert got.solve_iters == int(ref.solve_iters)
    assert _maxabs(ref.fields, got.fields) <= CHAIN_ATOL
    assert _maxabs(ref.frames, got.frames) <= 2e-3
    assert torch.equal(seq.fields[:2], got.fields[:2])


def test_video_frames_sharded_takes_the_reference_conf_flows():
    """The reference's ``conf_flows`` tuple ``(af, ab, bf, bb)`` of
    per-frame flow stacks, built as ``video.pipeline.render_video`` builds
    it (frame t's pair, the last frame the final pair reversed)."""
    t_len, h, w = 3, 40, 56
    ca, cb = bench._make_clips(t_len, h, w, seed=1)
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    fields = np.stack([np.stack([1.5 * np.sin(yy / 7.0 + k), 2.0 * np.cos(xx / 9.0 - k)], -1)
                       for k in range(t_len)]).astype(np.float32)
    flows = {k: (0.8 * rng.standard_normal((t_len - 1, h, w, 2))).astype(np.float32)
             for k in ("fa_fwd", "fa_bwd", "fb_fwd", "fb_bwd")}
    conf = tuple(np.concatenate([flows[f], flows[b][-1:]], 0)
                 for f, b in (("fa_fwd", "fa_bwd"), ("fa_bwd", "fa_fwd"), ("fb_fwd", "fb_bwd"),
                              ("fb_bwd", "fb_fwd")))
    times = np.linspace(0.0, 1.0, t_len, dtype=np.float32)
    jsp = JaxSynthParams()
    rb, rf = jfr.render_video_frames_sharded(
        jnp.asarray(ca), jnp.asarray(cb), jnp.asarray(fields), jnp.asarray(times),
        jax_make_mesh((1,), ("batch",)), jsp, JVP, "batch", conf_flows=tuple(jnp.asarray(c) for c in conf))
    args = (_t(ca), _t(cb), _t(fields), times, _mesh(1), _port(jsp), _port(JVP), "batch")
    pb, pf = tfr.render_video_frames_sharded(*args, conf_flows=tuple(_t(c) for c in conf))
    assert pf.shape == (t_len, h, w, 3)
    assert _maxabs(rf, pf) <= 1e-4
    assert _maxabs(rb, pb) <= 1e-4
    fb, ff = tfr.render_video_frames_sharded(*args, flows={k: _t(v) for k, v in flows.items()})
    assert torch.equal(ff, pf) and torch.equal(fb, pb)
    with pytest.raises(ValueError, match="conf_flows or flows"):
        tfr.render_video_frames_sharded(*args, conf_flows=tuple(_t(c) for c in conf),
                                        flows={k: _t(v) for k, v in flows.items()})
