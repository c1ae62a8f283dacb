"""Port parity: the pyramid flow, its levels, and the occlusion confidence.

The same seeded numpy inputs run through the JAX reference (its plain path
on the CPU) and the PyTorch port. Tolerances:

- flows: max abs <= 1e-4 px. Each level runs 2 warps of 40 Jacobi sweeps
  (80 per level, 5 x 8 in robust mode) in float32, and both sides round
  each sweep's sums and divisions separately (XLA may contract some of
  them), so one ulp of difference per sweep can grow to a few 1e-6 px; the
  bound leaves an order of magnitude above what the cases show (<= 2e-5).
- the batched clip solve against a loop over pairs: bitwise on the CPU
  (the same operations per pair);
- the occlusion confidence: max abs <= 1e-5 (``jax.nn.sigmoid`` and
  ``torch.sigmoid`` may round differently).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from videomorphing_tpu.config import VideoParams as JaxVideoParams
from videomorphing_tpu.ops import windows as jw
from videomorphing_tpu.video import flow as jf
from videomorphing_tpu.video import occlusion as jo
from videomorphing_tpu_torch.config import VideoParams
from videomorphing_tpu_torch.kernels import warp as kw
from videomorphing_tpu_torch.ops import windows as tw
from videomorphing_tpu_torch.video import flow as tf
from videomorphing_tpu_torch.video import occlusion as to

torch.set_num_threads(2)
FLOW_ATOL = 1e-4
CONF_ATOL = 1e-5
T_LEN, H, W = 4, 48, 64
CASES = {
    "default": dict(),                      # flow_scale shrink to 24 x 32, 1 level
    "levels3": dict(flow_levels=3),         # shrink and 3 levels
    "full-res": dict(flow_scale=1.0),       # 2 auto levels at 48 x 64
    "robust": dict(flow_robust=True, flow_levels=2),
}


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32).copy())


def _maxabs(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b.detach().numpy() if isinstance(b, torch.Tensor) else b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)))


@pytest.fixture(scope="module")
def clip():
    return bench._make_clips(T_LEN, H, W, seed=0)[0]


def _smooth_flow(h, w, seed, amp=2.0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, 4)
    return np.stack(
        [amp * np.sin(xx / 11.0 + ph[0]) + 0.3 * np.cos(yy / 7.0 + ph[1]),
         amp * np.cos(yy / 13.0 + ph[2]) - 0.2 * np.sin(xx / 5.0 + ph[3])], -1
    ).astype(np.float32)


@pytest.mark.parametrize("robust", [False, True])
def test_gray(clip, robust):
    jvp, vp = JaxVideoParams(flow_robust=robust), VideoParams(flow_robust=robust)
    ref = jf._gray(jnp.asarray(clip[0]), jvp)
    got = tf._gray(_t(clip[0]), vp)
    assert _maxabs(ref, got) <= 1e-4  # intensities in [0, 255]
    assert _maxabs(jf._gray(jnp.asarray(clip[0, ..., 0])), tf._gray(_t(clip[0, ..., 0]))) == 0.0


def test_separable_filter_robust_prefilter_taps():
    """The 25-tap edge-padded blur of the robust prefilter (sigma 6)."""
    x = np.random.default_rng(3).random((37, 53, 2), dtype=np.float32) * 255.0
    k = jw.gaussian_kernel_1d(int(4 * 6.0) | 1, 6.0)
    assert k.shape == (25,)
    ref = jw.separable_filter(jnp.asarray(x), k, mode="same_edge")
    got = tw.separable_filter(_t(x), tw.gaussian_kernel_1d(25, 6.0), mode="same_edge")
    assert _maxabs(ref, got) <= 1e-5 * 255.0


@pytest.mark.parametrize("level", ["hs", "robust"])
def test_one_level(clip, level):
    """One level from identical inputs: the warps, the Jacobi loop counts
    (``max(flow_iters // flow_irls, 1)`` per IRLS step in robust mode) and
    the clamp."""
    vp = VideoParams(flow_robust=level == "robust", flow_iters=12)
    jvp = JaxVideoParams(**dataclasses.asdict(vp))
    a, b = tf._gray(_t(clip[0])), tf._gray(_t(clip[1]))
    u0 = 0.3 * np.random.default_rng(5).standard_normal((H, W, 2)).astype(np.float32)
    jfn = jf._robust_level if level == "robust" else jf._hs_level
    ref = jax.jit(lambda a_, b_, u_: jfn(a_, b_, u_, jvp))(a.numpy(), b.numpy(), u0)
    got = tf._level_solver(vp)(a, b, _t(u0), vp)
    assert _maxabs(ref, got) <= FLOW_ATOL
    # the same level on a trailing batch of three problems, bitwise
    rng = np.random.default_rng(6)
    us = 0.3 * rng.standard_normal((H, W, 3, 2)).astype(np.float32)
    bs = torch.stack([b, tf._gray(_t(clip[2])), tf._gray(_t(clip[3]))], -1)
    batch = tf._level_solver(vp)(a[..., None].expand(H, W, 3), bs, _t(us), vp)
    for k in range(3):
        assert torch.equal(batch[:, :, k], tf._level_solver(vp)(a, bs[..., k].contiguous(), _t(us[:, :, k]), vp))


def test_flow_pair(clip):
    ref = jf.flow_pair(jnp.asarray(clip[0]), jnp.asarray(clip[1]), JaxVideoParams())
    got = tf.flow_pair(_t(clip[0]), _t(clip[1]), VideoParams())
    assert got.shape == (H, W, 2)
    assert _maxabs(ref, got) <= FLOW_ATOL


@pytest.mark.parametrize("case", list(CASES))
def test_flow_pair_bidir(clip, case):
    jvp, vp = JaxVideoParams(**CASES[case]), VideoParams(**CASES[case])
    rf, rb = jf.flow_pair_bidir(jnp.asarray(clip[1]), jnp.asarray(clip[2]), jvp)
    gf, gb = tf.flow_pair_bidir(_t(clip[1]), _t(clip[2]), vp)
    assert float(np.abs(np.asarray(rf)).max()) > 0.5  # a real motion
    assert _maxabs(rf, gf) <= FLOW_ATOL
    assert _maxabs(rb, gb) <= FLOW_ATOL


@pytest.mark.parametrize("case", ["default", "levels3"])
def test_clip_flows(clip, case):
    """All 2(T-1) problems of a clip in one batch: against the reference's
    per-pair map, and bitwise against the port's own per-pair solve."""
    jvp, vp = JaxVideoParams(**CASES[case]), VideoParams(**CASES[case])
    rf, rb = jf.clip_flows(jnp.asarray(clip), jvp)
    gf, gb = tf.clip_flows(_t(clip), vp)
    assert gf.shape == gb.shape == (T_LEN - 1, H, W, 2)
    assert _maxabs(rf, gf) <= FLOW_ATOL
    assert _maxabs(rb, gb) <= FLOW_ATOL
    for t in range(T_LEN - 1):
        pf, pb = tf.flow_pair_bidir(_t(clip[t]), _t(clip[t + 1]), vp)
        assert torch.equal(pf, gf[t]) and torch.equal(pb, gb[t])
    assert kw.bilinear_sample.launches == 0 and kw.bilinear_sample_batched.launches == 0


def test_occlusion_confidence():
    h, w = 40, 72
    fwd = np.stack([_smooth_flow(h, w, 1, 0.5), _smooth_flow(h, w, 2, 0.7)])
    bwd = -fwd.copy()  # round-trips up to the flows' variation ...
    bwd[:, 10:25, 20:45] += 3.0  # ... except in an occluded block
    vp = VideoParams()
    batched = to.occlusion_confidence(_t(fwd), _t(bwd), vp)
    assert batched.shape == (2, h, w)
    for k in range(2):
        ref = jo.occlusion_confidence(jnp.asarray(fwd[k]), jnp.asarray(bwd[k]), JaxVideoParams())
        single = to.occlusion_confidence(_t(fwd[k]), _t(bwd[k]), vp)
        assert torch.equal(single, batched[k])
        assert _maxabs(ref, single) <= CONF_ATOL
    assert 0.05 < float(batched.mean()) < 0.95  # both visible and occluded pixels
