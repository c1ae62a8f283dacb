"""Port parity: temporal advection of the halfway field and point tracking.

The same seeded numpy field and flows run through the JAX reference (its
plain path on the CPU) and the PyTorch port. Tolerances: max abs <= 1e-4 px
for fields and points (a handful of float32 samples and fixed-point steps,
with the reduced-resolution path's two resizes). The advection confidence
is ``1 - |p_new - p| / r``, where p holds coordinates of up to max(H, W)
px and r is ``advect_residual`` in that resolution's pixels: one float32
ulp of p moves it by ulp(max(H, W)) / r, so it is held to two such ulps
(4.1e-5 at both scales here); the splat oracle's scatter-adds sum in
another order, <= 1e-4 as well. The gather form against the splat oracle
follows the reference's own test (``tests/test_video.py``): < 0.15 px
where both are confident, away from the border.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videomorphing_tpu.config import VideoParams as JaxVideoParams
from videomorphing_tpu.video import temporal as jt
from videomorphing_tpu_torch.config import VideoParams
from videomorphing_tpu_torch.kernels import warp as kw
from videomorphing_tpu_torch.video import temporal as tt

torch.set_num_threads(2)
ATOL = 1e-4


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32).copy())


def _maxabs(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b.detach().numpy() if isinstance(b, torch.Tensor) else b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)))


def _fields(h, w, seed=0):
    """A smooth halfway field and the two clips' smooth flows (px)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, 6)
    v = np.stack([2.0 * np.sin(yy / 23.0 + ph[0]), 3.0 * np.cos(xx / 31.0 + ph[1])], -1)
    fa = np.stack([1.5 * np.sin(xx / 17.0 + ph[2]) + 0.3, 2.0 * np.cos(yy / 23.0 + ph[3])], -1)
    fb = np.stack([-1.5 * np.sin(xx / 19.0 + ph[4]), 2.0 * np.cos(yy / 13.0 + ph[5]) - 0.2], -1)
    return v.astype(np.float32), fa.astype(np.float32), fb.astype(np.float32)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_advect_halfway_field(scale):
    """At 128 x 160 the default advect_scale 0.5 takes the reduced-resolution
    inversion (with its residual threshold converted); 1.0 the full one."""
    v, fa, fb = _fields(128, 160)
    ref_v, ref_c = jt.advect_halfway_field(
        jnp.asarray(v), jnp.asarray(fa), jnp.asarray(fb), JaxVideoParams(advect_scale=scale)
    )
    got_v, got_c = tt.advect_halfway_field(_t(v), _t(fa), _t(fb), VideoParams(advect_scale=scale))
    assert got_v.shape == (128, 160, 2) and got_c.shape == (128, 160, 1)
    assert _maxabs(ref_v, got_v) <= ATOL
    h_in, w_in = round(128 * scale), round(160 * scale)  # the inversion's resolution
    residual_px = VideoParams().advect_residual * scale
    assert _maxabs(ref_c, got_c) <= 2 * float(np.spacing(np.float32(max(h_in, w_in)))) / residual_px
    assert 0.5 < float(got_c.mean()) < 1.0  # confident inside, not at the exits
    assert kw.bilinear_sample.launches == 0 and kw.bilinear_sample_batched.launches == 0


def test_splat_oracle_matches_reference():
    v, fa, fb = _fields(40, 48, seed=1)
    acc_r, w_r = jt.bilinear_splat(jnp.asarray(fa), jnp.asarray(v) + 20.0, (40, 48))
    acc_g, w_g = tt.bilinear_splat(_t(fa), _t(v) + 20.0, (40, 48))
    assert _maxabs(acc_r, acc_g) <= ATOL and _maxabs(w_r, w_g) <= ATOL
    ref = jt.advect_halfway_field_splat(jnp.asarray(v), jnp.asarray(fa), jnp.asarray(fb), JaxVideoParams())
    got = tt.advect_halfway_field_splat(_t(v), _t(fa), _t(fb), VideoParams())
    assert _maxabs(ref[0], got[0]) <= ATOL
    assert _maxabs(ref[1], got[1]) <= ATOL


def test_gather_advect_matches_splat_oracle():
    """The reference's own check, on the port: the gather inversion agrees
    with the forward-splat oracle where both are well defined."""
    h = w = 48
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ph, pw = 2 * np.pi * yy / h, 2 * np.pi * xx / w
    v = np.stack([0.8 * np.sin(ph), 1.2 * np.cos(pw)], -1)
    fa = np.stack([0.5 * np.cos(pw), 1.0 + 0.4 * np.sin(ph)], -1)
    fb = np.stack([-0.3 * np.sin(pw), 0.8 - 0.4 * np.cos(ph)], -1)
    vp = VideoParams()
    tc_v, tc_w = tt.advect_halfway_field(_t(v), _t(fa), _t(fb), vp)
    sp_v, sp_w = tt.advect_halfway_field_splat(_t(v), _t(fa), _t(fb), vp)
    both = (tc_w[..., 0] > 0.5) & (sp_w[..., 0] > 0.5)
    inner = torch.zeros((h, w), dtype=torch.bool)
    inner[6:-6, 6:-6] = True
    m = both & inner
    assert float(m.float().mean()) > 0.5
    assert float((tc_v - sp_v).abs()[m].max()) < 0.15


@pytest.mark.parametrize("n", [4, 0])
def test_track_points(n):
    _, fa, fb = _fields(40, 56, seed=2)
    rng = np.random.default_rng(n)
    pts = np.stack([rng.uniform(-2, 41, (n, 2)), rng.uniform(-2, 57, (n, 2))], -1).astype(np.float32)
    pts = pts.reshape(n, 2, 2)
    ref = jt.track_points(jnp.asarray(pts), jnp.asarray(fa), jnp.asarray(fb))
    got = tt.track_points(_t(pts), _t(fa), _t(fb))
    assert got.shape == (n, 2, 2)
    if n:
        assert _maxabs(ref, got) <= ATOL


@pytest.mark.parametrize("keys", [(0,), (2,), (0, 3)], ids=["k0", "k2", "k0-3"])
def test_track_keyframe_points(keys):
    """Forward from the first keyframe with re-anchoring at later ones, and
    backward (with the reverse flows) before it."""
    t_len, h, w = 5, 32, 40
    flows = [np.stack([_fields(h, w, seed=10 * s + t)[1 + s % 2] for t in range(t_len - 1)])
             for s in range(4)]
    rng = np.random.default_rng(7)
    key_pts = np.stack(
        [rng.uniform(4, 28, (len(keys), 3, 2)), rng.uniform(4, 36, (len(keys), 3, 2))], -1
    ).astype(np.float32).transpose(0, 1, 3, 2)
    ref = jt.track_keyframe_points(t_len, list(keys), jnp.asarray(key_pts), *map(jnp.asarray, flows))
    got = tt.track_keyframe_points(t_len, list(keys), _t(key_pts), *map(_t, flows))
    assert got.shape == (t_len, 3, 2, 2)
    assert _maxabs(ref, got) <= ATOL
    for k, idx in enumerate(keys):
        assert torch.equal(got[idx], _t(key_pts[k]))
