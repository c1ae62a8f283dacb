"""Port parity: the warm frame loop, the video render and ``api.morph_clips``.

One JAX ``solve_clip_fields`` at T = 4, 32 x 48 with 2 points (module
fixture) provides flows, tracked points and fields; ``interop`` carries them
across, so each part is compared from identical inputs, apart from drift
upstream of it.

Tolerances:

- each warm frame solved from the reference's previous field, flows and
  points: the same iteration count and the field within 1e-3 px, the
  solver-drift bound of the pair solve (``test_torch_solver.py``);
- the chained loop over three warm frames from the reference's frame-0
  field: the same iteration counts and the field within 5e-3 px. Drift
  compounds through each frame's advection: the reference moves its own
  chained result by up to 1.1e-3 px on this case when its frame-0 field is
  perturbed by 1e-6 px, and the port's float32 roundings are such a
  perturbation;
- the render from the reference's fields (with and without occlusion
  weighting): max abs <= 1e-4, as the pair render;
- ``morph_clips`` end to end: frames within 2e-3 (flow, solver and render
  drift together);
- ``resume_clip_fields`` against the tail of the full solve: bitwise (the
  same loop entered mid-clip).
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
from videomorphing_tpu.video import pipeline as jp
from videomorphing_tpu_torch import api
from videomorphing_tpu_torch.config import MorphParams, SynthParams, VideoParams
from videomorphing_tpu_torch.interop import fields_from_numpy, flows_from_numpy
from videomorphing_tpu_torch.utils import profiling
from videomorphing_tpu_torch.video import pipeline as tp

torch.set_num_threads(2)
T_LEN, H, W = 4, 32, 48
JMP = JaxMorphParams(iters_coarse=8, iters_fine=4)
JVP = JaxVideoParams()
FIELD_ATOL = 1e-3
CHAIN_ATOL = 5e-3
RENDER_ATOL = 1e-4


def _port(p):
    cls = {JaxMorphParams: MorphParams, JaxSynthParams: SynthParams, JaxVideoParams: VideoParams}[type(p)]
    return cls(**dataclasses.asdict(p))


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _maxabs(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b.detach().numpy() if isinstance(b, torch.Tensor) else b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)))


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
    """The reference's fields, tracked points, flows and iteration count."""
    ca, cb, pts = clips
    fields, tracked, flows, iters = jp.solve_clip_fields(
        jnp.asarray(ca), jnp.asarray(cb), jnp.asarray(pts), JMP, JVP, return_stats=True
    )
    return (np.asarray(fields), np.asarray(tracked),
            {k: np.asarray(v) for k, v in flows.items()}, int(iters))


def _scan_both(clips, solved, jvp, start, stop, v_prev):
    """The reference's and the port's warm loop over frames [start, stop)
    from the field ``v_prev`` of frame start - 1 and the reference's flows
    and tracked points: ``(ref, ref_iters_total, got, iters_per_frame)``."""
    ca, cb, _ = clips
    _, tracked, flows, _ = solved
    sl, fl = slice(start, stop), slice(start - 1, stop - 1)
    ref, ref_iters = jp._jitted_frame_scan(JMP, jvp, (H, W))(
        jnp.asarray(ca[sl]), jnp.asarray(cb[sl]), jnp.asarray(v_prev), jnp.asarray(tracked[sl]),
        jnp.asarray(flows["fa_fwd"][fl]), jnp.asarray(flows["fb_fwd"][fl]),
    )
    pflows = flows_from_numpy({k: flows[k][fl] for k in ("fa_fwd", "fb_fwd")})
    got, iters = tp._frame_scan(_port(JMP), _port(jvp), (H, W))(
        _t(ca[sl]), _t(cb[sl]), fields_from_numpy(v_prev), _t(tracked[sl]),
        pflows["fa_fwd"], pflows["fb_fwd"],
    )
    return ref, int(ref_iters), got, iters


def test_default_times_match_jnp_linspace():
    for n in (1, 2, 3, 4, 16, 29, 30, 31, 64):
        ref = np.asarray(jnp.linspace(0.0, 1.0, n, dtype=jnp.float32))
        np.testing.assert_array_equal(ref, tp._default_times(n, "cpu").numpy())


def test_warm_level_count():
    for hw in ((32, 48), (1080, 1920), (2160, 3840), (20, 24)):
        for levels in (0, 1, 2, 3):
            assert tp.warm_level_count(hw, VideoParams(warm_levels=levels)) == jp.warm_level_count(
                hw, JaxVideoParams(warm_levels=levels)
            )


def test_warm_frames_from_reference_fields(clips, solved):
    """(a) Each warm frame from identical inputs: the reference's field of
    the previous frame, its flows and tracked points."""
    fields = solved[0]
    for t in range(1, T_LEN):
        ref, ref_iters, got, iters = _scan_both(clips, solved, JVP, t, t + 1, fields[t - 1])
        assert iters == [ref_iters]
        assert _maxabs(ref, got) <= FIELD_ATOL


def test_warm_loop_from_reference_flows(clips, solved):
    """(a) The chained loop over all warm frames from the reference's
    frame-0 field: the same iteration counts, drift bounded (see above)."""
    fields = solved[0]
    ref, ref_iters, got, iters = _scan_both(clips, solved, JVP, 1, T_LEN, fields[0])
    assert len(iters) == T_LEN - 1 and sum(iters) == ref_iters
    assert _maxabs(ref, got) <= CHAIN_ATOL
    assert _maxabs(fields[1:], got) <= CHAIN_ATOL


def test_warm_levels_3(clips, solved):
    """(e) The 3-level warm solve that frames over 2.4 Mpx take, forced at
    32 x 48 (levels 32 x 48, 16 x 24, 8 x 12), each frame from identical
    inputs. Budgets of 5 iterations per level: at the default 20/12 the
    8 x 12 and 16 x 24 levels stop on the stall test at its tolerance, and
    the reference itself then changes its iteration counts (20 -> 13) and
    its field (by 1.2 px) when its start moves by 1e-7 px; at 5 it is
    stable to 4e-5 px."""
    fields = solved[0]
    jvp = JaxVideoParams(warm_levels=3, warm_iters_mid=5, warm_iters_fine=5)
    assert tp.warm_level_count((H, W), _port(jvp)) == 3
    for t in range(1, T_LEN):
        ref, ref_iters, got, iters = _scan_both(clips, solved, jvp, t, t + 1, fields[t - 1])
        assert iters == [ref_iters] == [15]
        assert _maxabs(ref, got) <= FIELD_ATOL


@pytest.mark.parametrize("occlusion", [True, False])
def test_render_video_from_reference_fields(clips, solved, occlusion):
    """(b) Bulges, confidences (the last frame reusing the final pair's
    reverse) and the occlusion-aware render from the reference's fields."""
    ca, cb, _ = clips
    fields, _, flows, _ = solved
    jsp = JaxSynthParams(occlusion_weighting=occlusion)
    ref = jp.render_video(jnp.asarray(ca), jnp.asarray(cb), jnp.asarray(fields), sp=jsp, vp=JVP,
                          flows={k: jnp.asarray(v) for k, v in flows.items()})
    got = tp.render_video(_t(ca), _t(cb), fields_from_numpy(fields), sp=_port(jsp), vp=VideoParams(),
                          flows=flows_from_numpy(flows))
    assert got.frames.shape == (T_LEN, H, W, 3)
    assert _maxabs(ref.bulges, got.bulges) <= RENDER_ATOL
    assert _maxabs(ref.frames, got.frames) <= RENDER_ATOL
    if occlusion:
        conf = tp._clip_confidences(_t(flows["fa_fwd"]), _t(flows["fa_bwd"]), T_LEN, VideoParams())
        ref_conf = jp._clip_confidences(jnp.asarray(flows["fa_fwd"]), jnp.asarray(flows["fa_bwd"]), T_LEN, JVP)
        assert conf.shape == (T_LEN, H, W) and _maxabs(ref_conf, conf) <= 1e-5


def test_morph_clips_end_to_end(clips, solved):
    """(c) ``api.morph_clips`` in both packages, and the stages it records."""
    ca, cb, pts = clips
    ref = jax_api.morph_clips(ca, cb, pts, mp=JMP, sp=JaxSynthParams(), vp=JVP)
    with profiling.record_phases() as rec:
        got = api.morph_clips(ca, cb, pts, mp=_port(JMP), sp=SynthParams(), vp=VideoParams(), device="cpu")
    assert got.frames.shape == (T_LEN, H, W, 3) and got.frames.dtype == torch.float32
    assert _maxabs(ref.frames, got.frames) <= 2e-3
    assert _maxabs(ref.tracked_points, got.tracked_points) <= 1e-4
    assert got.solve_iters == int(ref.solve_iters) == solved[3]
    stages = {"flows", "tracking", "cold_solve", "warm_loop", "bulges", "confidences", "render"}
    assert stages <= set(rec) and all(rec[s] >= 0.0 for s in stages)
    assert len(rec["warm_iters"]) == T_LEN - 1


def test_keyframe_points_and_render_off(clips):
    """Keyframe-dict points through ``api.morph_clips`` (tracked as the
    reference tracks them), with the render off."""
    ca, cb, pts = clips
    keys = {0: pts, 2: pts + np.float32(0.5)}
    ref = jp.solve_clip_fields(jnp.asarray(ca), jnp.asarray(cb), {k: jnp.asarray(v) for k, v in keys.items()},
                               JMP, JVP)[1]
    got = api.morph_clips(ca, cb, keys, mp=_port(JMP), render=False, device="cpu")
    assert got.frames is None and got.fields.shape == (T_LEN, H, W, 2)
    assert _maxabs(ref, got.tracked_points) <= 1e-4
    assert torch.equal(got.tracked_points[2], _t(keys[2]))
    with pytest.raises(ValueError, match="same N"):
        api.morph_clips(ca, cb, {0: pts, 1: pts[:1]}, device="cpu")


def test_resume_clip_fields_equals_tail(clips):
    """(d) Resuming from a solved frame gives the full solve's tail."""
    ca, cb, pts = clips
    mp, vp = _port(JMP), VideoParams()
    fields, _, _ = tp.solve_clip_fields(_t(ca), _t(cb), _t(pts), mp, vp)
    for start in (1, 2):
        tail = tp.resume_clip_fields(_t(ca), _t(cb), fields[start - 1], start, _t(pts), mp, vp)
        assert torch.equal(tail, fields[start:])
    with pytest.raises(ValueError):
        tp.resume_clip_fields(_t(ca), _t(cb), fields[0], 0, _t(pts), mp, vp)
