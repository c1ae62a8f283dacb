"""Port parity: windows, SSIM, pyramids, DCT and Poisson extension.

Same numpy inputs through the JAX reference and the PyTorch port on the
CPU. Tolerance: relative error max|ref - got| / max|ref| <= 1e-5 (float32
on both sides; sums are taken in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videomorphing_tpu.ops import poisson as jp
from videomorphing_tpu.ops import pyramid as jpy
from videomorphing_tpu.ops import ssim as js
from videomorphing_tpu.ops import windows as jw
from videomorphing_tpu_torch.ops import poisson as tp
from videomorphing_tpu_torch.ops import pyramid as tpy
from videomorphing_tpu_torch.ops import ssim as ts
from videomorphing_tpu_torch.ops import windows as tw

torch.set_num_threads(2)
RTOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32).copy())


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.max(np.abs(ref - got)) / (np.max(np.abs(ref)) + 1e-12))


def _img(seed, h=37, w=53, c=3):
    return np.random.default_rng(seed).random((h, w, c), dtype=np.float32)


@pytest.mark.parametrize("mode", ["same_zero", "same_edge"])
def test_separable_filter(mode):
    x = _img(1)
    k = jw.gaussian_kernel_1d(5, 1.0)
    ref = jw.separable_filter(jnp.asarray(x), k, k, mode=mode)
    got = tw.separable_filter(_t(x), tw.gaussian_kernel_1d(5, 1.0), mode=mode)
    assert _rel(ref, got) <= RTOL


def test_median3x3():
    x = _img(2, c=2)
    np.testing.assert_array_equal(
        np.asarray(jw.median3x3(jnp.asarray(x))), tw.median3x3(_t(x)).numpy()
    )


def test_ssim_parts_and_map():
    a, b = _img(3), _img(4)
    ref = js.ssim_parts(jnp.asarray(a), jnp.asarray(b))
    got = ts.ssim_parts(_t(a), _t(b))
    for k in ("mu0", "mu1", "var0", "var1", "cov", "n"):
        assert _rel(ref[k], got[k]) <= RTOL, k
    assert _rel(js.dssim_map(jnp.asarray(a), jnp.asarray(b)), ts.dssim_map(_t(a), _t(b))) <= RTOL


@pytest.mark.parametrize("use_luminance", [True, False])
def test_dssim_grad_bundle(use_luminance):
    a = _img(5)
    b = np.clip(a + 0.1 * _img(6), 0, 1).astype(np.float32)
    ref = js.dssim_grad_bundle(jnp.asarray(a), jnp.asarray(b), use_luminance=use_luminance)
    got = ts.dssim_grad_bundle(_t(a), _t(b), use_luminance=use_luminance)
    for name in ("energy", "g0", "g1", "b2"):
        assert _rel(getattr(ref, name), getattr(got, name)) <= RTOL, name
    # dmap = 1 - s with s close to 1: its error is set by the float32 ulp of
    # s, so it is held relative to the scale of s (1), not of dmap
    assert np.max(np.abs(np.asarray(ref.dmap) - got.dmap.numpy())) <= RTOL


@pytest.mark.parametrize("hw", [(37, 53), (16, 16), (1024, 768)])
def test_pyramid_shapes(hw):
    h, w = hw
    for min_size in (16, 32):
        n = jpy.auto_n_levels(h, w, min_size)
        assert tpy.auto_n_levels(h, w, min_size) == n
        assert tpy.pyramid_shapes(h, w, n) == jpy.pyramid_shapes(h, w, n)


@pytest.mark.parametrize("hw", [(37, 53), (64, 48)])
def test_downsample_and_pyramid(hw):
    x = _img(7, *hw)
    assert _rel(jpy.downsample_2x(jnp.asarray(x)), tpy.downsample_2x(_t(x))) <= RTOL
    ref = jpy.gaussian_pyramid(jnp.asarray(x), 3)
    got = tpy.gaussian_pyramid(_t(x), 3)
    for r, g in zip(ref, got):
        assert _rel(r, g) <= RTOL


@pytest.mark.parametrize("src,dst", [((68, 34), (135, 67)), ((19, 27), (37, 53)), ((32, 32), (64, 64))])
def test_upsample_field_2x(src, dst):
    """Ceil-ratio level shapes, against jax.image.resize."""
    v = 3.0 * np.random.default_rng(8).standard_normal(src + (2,)).astype(np.float32)
    ref = jpy.upsample_field_2x(jnp.asarray(v), dst)
    got = tpy.upsample_field_2x(_t(v), dst)
    assert _rel(ref, got) <= RTOL
    direct = jax.image.resize(jnp.asarray(v), dst + (2,), method="bilinear")
    assert _rel(direct, tpy.resize_bilinear(_t(v), dst)) <= RTOL


def test_resize_shrink_matches_jax():
    x = _img(9, 50, 41)
    ref = jax.image.resize(jnp.asarray(x), (23, 17, 3), method="bilinear")
    assert _rel(ref, tpy.resize_bilinear(_t(x), (23, 17))) <= RTOL


@pytest.mark.parametrize("dst", [(23, 31), (75, 90)])
def test_resample_field(dst):
    from videomorphing_tpu.solver.ctf import resample_field as jax_resample
    from videomorphing_tpu_torch.solver.ctf import resample_field

    v = 4.0 * np.random.default_rng(12).standard_normal((40, 52, 2)).astype(np.float32)
    assert _rel(jax_resample(jnp.asarray(v), dst), resample_field(_t(v), dst)) <= RTOL


@pytest.mark.parametrize("n", [7, 64])
def test_dct_against_f64_basis(n):
    x = np.random.default_rng(n).standard_normal((n, n + 3, 2)).astype(np.float64)
    cy, cx = jp._dct_mat_np(n).astype(np.float64), jp._dct_mat_np(n + 3).astype(np.float64)
    ref = np.einsum("km,mnc->knc", cy, x)
    ref = np.einsum("ln,knc->klc", cx, ref)
    got = tp.dct2(_t(x))
    assert _rel(ref, got) <= RTOL
    assert _rel(x, tp.idct2(got)) <= RTOL


def test_screened_poisson_and_gradients():
    x = _img(10)
    ref = jp.screened_poisson_dct(jnp.asarray(x), 1.0, 25.0)
    got = tp.screened_poisson_dct(_t(x), 1.0, 25.0)
    assert _rel(ref, got) <= RTOL
    gy, gx = jp.forward_gradients(jnp.asarray(x))
    ty, tx = tp.forward_gradients(_t(x))
    assert _rel(gy, ty) <= RTOL and _rel(gx, tx) <= RTOL
    assert _rel(jp.divergence(gy, gx), tp.divergence(ty, tx)) <= RTOL


@pytest.mark.parametrize("jacobi", [0, 3])
def test_pull_push_extend(jacobi):
    x = _img(11)
    yy, xx = np.mgrid[0:37, 0:53]
    wgt = ((yy - 18) ** 2 + (xx - 26) ** 2 > 100).astype(np.float32)
    ref = jp.pull_push_extend(jnp.asarray(x), jnp.asarray(wgt), jacobi_iters=jacobi)
    got = tp.pull_push_extend(_t(x), _t(wgt), jacobi_iters=jacobi)
    assert _rel(ref, got) <= RTOL
