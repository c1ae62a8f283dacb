"""Port parity: sampling and the plain versions of kernels 3 and 4.

Each case runs the same numpy inputs (made from a seed) through the JAX
reference and its PyTorch counterpart on the CPU. Tolerance: max abs
<= 1e-6 (inputs in [0, 1]; both sides compute the same float32 operations,
the slack covers XLA's fused multiply-adds).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videomorphing_tpu.ops import resample as jr
from videomorphing_tpu_torch.kernels import warp as kw
from videomorphing_tpu_torch.ops import resample as tr

torch.set_num_threads(2)
ATOL = 1e-6


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32).copy())


def _maxabs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def _coords(rng, h, w, shape):
    """Coordinates inside, on the edges of, and off the frame, with some
    exact integers (the clamp and derivative-mask boundaries)."""
    c = np.stack(
        [rng.uniform(-4.0, h + 3.0, shape), rng.uniform(-4.0, w + 3.0, shape)], -1
    ).astype(np.float32)
    flat = c.reshape(-1, 2)
    flat[:6] = [[0, 0], [h - 1, w - 1], [0, w - 1], [h - 1, 0], [2, 3], [-1, w]]
    return c


@pytest.mark.parametrize("c", [1, 3, 4])
def test_bilinear_sample(c):
    rng = np.random.default_rng(c)
    h, w = 23, 31
    img = rng.random((h, w, c), dtype=np.float32)
    co = _coords(rng, h, w, (17, 19))
    ref = jr.bilinear_sample(jnp.asarray(img), jnp.asarray(co))
    got = tr.bilinear_sample(_t(img), _t(co))
    assert got.shape == tuple(ref.shape)
    assert _maxabs(ref, got) <= ATOL


def test_bilinear_sample_2d_image():
    rng = np.random.default_rng(7)
    img = rng.random((12, 9), dtype=np.float32)
    co = _coords(rng, 12, 9, (5, 6))
    ref = jr.bilinear_sample(jnp.asarray(img), jnp.asarray(co))
    got = tr.bilinear_sample(_t(img), _t(co))
    assert got.shape == tuple(ref.shape)
    assert _maxabs(ref, got) <= ATOL


@pytest.mark.parametrize("c", [1, 3])
def test_bilinear_sample_with_grad(c):
    rng = np.random.default_rng(10 + c)
    h, w = 21, 26
    img = rng.random((h, w, c), dtype=np.float32)
    co = _coords(rng, h, w, (h, w))
    rv, rd = jr.bilinear_sample_with_grad(jnp.asarray(img), jnp.asarray(co))
    gv, gd = tr.bilinear_sample_with_grad(_t(img), _t(co))
    assert gd.shape == tuple(rd.shape) == (h, w, c, 2)
    assert _maxabs(rv, gv) <= ATOL
    assert _maxabs(rd, gd) <= ATOL
    # clamped coordinates have zero derivative on both sides
    off = (co[..., 0] <= 0) | (co[..., 0] >= h - 1)
    assert off.any() and np.all(gd.numpy()[off][..., 0] == 0.0)


def test_bicubic_sample():
    rng = np.random.default_rng(3)
    h, w = 19, 24
    img = rng.random((h, w, 3), dtype=np.float32)
    co = _coords(rng, h, w, (9, 11))
    ref = jr.bicubic_sample(jnp.asarray(img), jnp.asarray(co))
    got = tr.bicubic_sample(_t(img), _t(co))
    assert _maxabs(ref, got) <= 1e-5  # 16 weighted taps: a few ulps of slack


def test_inside_mask_and_grid():
    rng = np.random.default_rng(4)
    co = _coords(rng, 10, 14, (8, 9))
    for margin in (0.0, 1.5):
        ref = jr.inside_mask(jnp.asarray(co), 10, 14, margin)
        got = tr.inside_mask(_t(co), 10, 14, margin)
        np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    np.testing.assert_array_equal(np.asarray(jr.grid_coords(5, 7)), tr.grid_coords(5, 7).numpy())


def _smooth_field(h, w, amp, seed):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    rng = np.random.default_rng(seed)
    ph = rng.uniform(0, 2 * np.pi, 2)
    return np.stack(
        [amp * np.sin(yy / 17.0 + ph[0]), amp * np.cos(xx / 23.0 + ph[1])], -1
    ).astype(np.float32)


def test_halfway_warp_plain_matches_fused_warp_planes():
    """Kernel 3's plain version against the Pallas warp kernel run in
    interpret mode: same values, derivatives and plane order."""
    from videomorphing_tpu.pallas.warp import fused_warp_planes

    rng = np.random.default_rng(0)
    h, w, c = 64, 256, 3
    i0 = rng.random((h, w, c), dtype=np.float32)
    i1 = rng.random((h, w, c), dtype=np.float32)
    v = _smooth_field(h, w, 2.5, 1)
    ref = fused_warp_planes(jnp.asarray(i0), jnp.asarray(i1), jnp.asarray(v), interpret=True)
    got = kw.halfway_warp(_t(i0), _t(i1), _t(v))
    assert got.shape == tuple(ref.shape) == (6 * c, h, w)
    assert _maxabs(ref, got) <= ATOL
    assert kw.halfway_warp.launches == 0


@pytest.mark.parametrize("c", [1, 3, 4])
def test_sampler_plain_matches_reference(c):
    """Kernel 4's plain version against the reference bilinear_sample on an
    arbitrary smooth coordinate map running off the frame."""
    rng = np.random.default_rng(20 + c)
    h, w = 40, 72
    img = rng.random((h, w, c), dtype=np.float32)
    g = np.stack(np.mgrid[0:h, 0:w], -1).astype(np.float32)
    co = g + _smooth_field(h, w, 9.0, c)
    ref = jr.bilinear_sample(jnp.asarray(img), jnp.asarray(co))
    got = kw.bilinear_sample(_t(img), _t(co))
    assert _maxabs(ref, got) <= ATOL
    assert kw.bilinear_sample.launches == 0
