"""The port's stressor (``utils.stressor``) against the reference's, and its
ground truth driving the port's flow, occlusion and morph stack at the
reference's test size (4, 72, 104).

- ``make_stressor`` equals the reference's when both get the reference's
  ``jax.random`` draws: clips and mid frames within 1e-6, the true flows,
  masks, points, crop and offset exactly;
- ``flow_epe``, ``occlusion_f1`` and ``midframe_ssim`` equal the
  reference's on the same inputs within 1e-5 (float32 sums in another
  order; the SSIM windows as ``tests/test_torch_exports.py`` holds them);
- on the reference's seed-3 scene (its draws handed over, as its claims
  were measured there: the occlusion recall depends on the texture, 0.17
  to 0.66 over the reference's seeds 0-3 in both packages alike), the
  ground truth describes the port's rendered clips (a gain-compensated
  warp residual < 0.02), and the reference's end-to-end claims hold for
  the port: Horn-Schunck tracks the background without drift (EPE < 0.5,
  occlusion recall > 0.3), the robust flow survives the drift (EPE < 0.5,
  Horn-Schunck at least twice worse), and the morph with the robust flow
  beats the cross-dissolve on the analytic mid frames.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from videomorphing_tpu.utils import stressor as js
from videomorphing_tpu_torch.config import VideoParams
from videomorphing_tpu_torch.ops.resample import bilinear_sample, grid_coords
from videomorphing_tpu_torch.utils import stressor as ts
from videomorphing_tpu_torch.utils.golden import ssim
from videomorphing_tpu_torch.video.flow import flow_pair_bidir
from videomorphing_tpu_torch.video.occlusion import occlusion_confidence
from videomorphing_tpu_torch.video.pipeline import morph_video

torch.set_num_threads(2)
T, H, W = 4, 72, 104


def jax_draws(seed):
    """The reference's texture draws of ``make_stressor(seed=seed)``."""
    from test_torch_golden import jax_texture_params

    k_bg, k_fg = jax.random.split(jax.random.PRNGKey(seed))
    return jax_texture_params(k_bg), jax_texture_params(k_fg, 3, 16, 6.0, 40.0)


@pytest.fixture(scope="module")
def case():
    return ts.make_stressor(T, H, W, seed=3, params=jax_draws(3), device="cpu")


def test_make_stressor_matches_reference():
    ref = js.make_stressor(T, H, W, seed=3)
    got = ts.make_stressor(T, H, W, seed=3, params=jax_draws(3), device="cpu")
    for name in ("clip_a", "clip_b", "mid_true"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), rtol=0, atol=1e-6)
    for name in ("flow_a_true", "flow_b_true", "valid_a", "valid_b", "occ_a", "occ_b", "disk_a", "disk_b"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)
    np.testing.assert_array_equal(got.points, ref.points)
    assert got.crop == ref.crop and got.disk_offset == ref.disk_offset


def test_metrics_match_reference():
    rng = np.random.default_rng(7)
    flow = (2.0 * rng.standard_normal((3, 20, 24, 2))).astype(np.float32)
    true = (2.0 * rng.standard_normal((3, 20, 24, 2))).astype(np.float32)
    valid = rng.random((3, 20, 24)) < 0.7
    conf = rng.random((3, 20, 24)).astype(np.float32)
    occ = rng.random((3, 20, 24)) < 0.2
    t = torch.from_numpy
    ref, got = js.flow_epe(flow, true, valid), ts.flow_epe(t(flow), t(true), t(valid))
    assert got.keys() == ref.keys() and all(abs(got[k] - ref[k]) <= 1e-5 for k in ref), (got, ref)
    ref, got = js.occlusion_f1(conf, occ), ts.occlusion_f1(t(conf), t(occ))
    assert got.keys() == ref.keys() and all(abs(got[k] - ref[k]) <= 1e-12 for k in ref), (got, ref)
    jcase = js.make_stressor(T, 40, 48, seed=1)
    tcase = ts.make_stressor(T, 40, 48, seed=1, params=jax_draws(1), device="cpu")
    frames = rng.random((T, 40, 48, 3)).astype(np.float32)
    ref, got = js.midframe_ssim(frames, jcase), ts.midframe_ssim(t(frames), tcase)
    assert abs(got["ssim_mid_mean"] - ref["ssim_mid_mean"]) <= 1e-5
    assert abs(got["ssim_mid_min"] - ref["ssim_mid_min"]) <= 1e-5
    np.testing.assert_allclose(got["per_frame"], ref["per_frame"], rtol=0, atol=1e-5 + 1e-12)


def test_scene_shapes_and_ranges(case):
    assert tuple(case.clip_a.shape) == (T, H, W, 3) and tuple(case.mid_true.shape) == (T, H, W, 3)
    assert tuple(case.flow_a_true.shape) == (T - 1, H, W, 2)
    a = case.clip_a.numpy()
    assert a.min() >= 0.0 and a.max() <= 1.0
    assert np.ptp(a.mean(axis=(1, 2, 3))) > 0.01
    assert all(int(case.occ_a[t].sum()) > 10 for t in range(T - 1))
    assert 0.5 < float(case.valid_a.float().mean()) < 0.999


def test_true_flow_is_consistent_with_frames(case):
    t = 1
    warped = bilinear_sample(case.clip_a[t + 1], grid_coords(H, W) + case.flow_a_true[t])
    v = case.valid_a[t].numpy()
    wa, aa = warped.numpy()[v], case.clip_a[t].numpy()[v]
    gain = float((wa * aa).sum() / max((wa * wa).sum(), 1e-9))
    assert np.abs(gain * wa - aa).mean() < 0.02


def test_hs_flow_tracks_background_without_drift():
    nodrift = ts.make_stressor(T, H, W, seed=3, drift=0.0, params=jax_draws(3), device="cpu")
    # occlusion_thresh 0.5 at this small size, as the reference's test sets it
    vp = VideoParams(occlusion_thresh=0.5)
    fwd, bwd = flow_pair_bidir(nodrift.clip_a[1], nodrift.clip_a[2], vp)
    bg = nodrift.valid_a[1] & ~nodrift.disk_a[1]
    m = ts.flow_epe(fwd[None], nodrift.flow_a_true[1][None], bg[None])
    assert m["epe_mean"] < 0.5, m
    det = ts.occlusion_f1(occlusion_confidence(fwd, bwd, vp)[None], nodrift.occ_a[1][None])
    assert det["recall"] > 0.3, det


def test_robust_flow_rescues_lighting_drift(case):
    bg = case.valid_a[1] & ~case.disk_a[1]
    epe = {}
    for robust in (False, True):
        fwd, _ = flow_pair_bidir(case.clip_a[1], case.clip_a[2], VideoParams(flow_robust=robust))
        epe[robust] = ts.flow_epe(fwd[None], case.flow_a_true[1][None], bg[None])["epe_mean"]
    assert epe[True] < 0.5, epe
    assert epe[False] > 2.0 * epe[True], epe


def test_end_to_end_morph_beats_cross_dissolve(case):
    times = torch.full((T,), 0.5)
    got = {}
    for robust in (False, True):
        res = morph_video(case.clip_a, case.clip_b, points={0: torch.from_numpy(case.points)}, times=times,
                          vp=VideoParams(flow_robust=robust), render=True)
        got[robust] = ts.midframe_ssim(res.frames, case)["ssim_mid_mean"]
    dissolve = 0.5 * (case.clip_a + case.clip_b)
    base = float(np.mean([ssim(dissolve[t], case.mid_true[t], crop=case.crop) for t in range(T)]))
    assert got[True] > base + 0.01, (got, base)
    assert got[True] > got[False] + 0.01, got
    assert got[True] > 0.9, got
