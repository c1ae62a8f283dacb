"""Port parity: the level solver and the coarse-to-fine loop.

One ``make_level_solver`` level runs from identical inputs in both packages
(``interop.level_data_from_numpy``), then ``optimize_pair`` runs end to end
at 96 x 128 with 2 point constraints.

Tolerances: the same ``iters`` and final step per level; the first level's
e0 (one energy evaluation on identical inputs) within a relative 1e-5;
e_final, later levels' e0 and the energy history within a relative 1e-3;
the field within 1e-3 px (1e-2 px for exact re-warps every iteration). The
trajectory gets more slack than one evaluation: the step is -grad/precond,
and where the preconditioner underestimates the curvature it multiplies
float32 rounding differences of the gradient, which feed every later
iteration. The reference is as sensitive to itself: a 1e-7 px perturbation
of its initial field moves its own 20-iteration result on this level case
by 0.18 px (0.32 px with re-warps every iteration).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videomorphing_tpu.config import MorphParams as JaxMorphParams
from videomorphing_tpu.solver import descent as jd
from videomorphing_tpu.solver.ctf import optimize_pair as jax_optimize_pair
from videomorphing_tpu.solver.energy import make_level_data
from videomorphing_tpu_torch.config import MorphParams
from videomorphing_tpu_torch.interop import level_data_from_numpy
from videomorphing_tpu_torch.solver import descent as td
from videomorphing_tpu_torch.solver.ctf import optimize_pair

torch.set_num_threads(2)
FIELD_ATOL = 1e-3


def _port(p):
    return MorphParams(**dataclasses.asdict(p))


def _texture(h, w, seed, shift=(0.0, 0.0)):
    """Smooth multi-scale texture, shifted by ``shift`` px (a known motion)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    yy, xx = yy - shift[0], xx - shift[1]
    out = np.full((h, w, 3), 0.5)
    for _ in range(12):
        f = rng.uniform(0.05, 0.3, 2)
        out += rng.uniform(0.02, 0.05, 3) * np.cos(f[0] * yy + f[1] * xx + rng.uniform(0, 6.3))[..., None]
    return np.clip(out, 0, 1).astype(np.float32)


def _assert_stats(ref, got, e0_rtol=1e-5):
    assert int(ref.iters) == got.iters
    assert abs(got.e0 - float(ref.e0)) <= e0_rtol * abs(float(ref.e0))
    assert abs(got.e_final - float(ref.e_final)) <= 1e-3 * abs(float(ref.e_final))
    assert got.step == float(ref.step)


@pytest.fixture(scope="module")
def level_case():
    h, w = 40, 56
    i0 = _texture(h, w, 1, (0.0, 0.0))
    i1 = _texture(h, w, 1, (1.5, -2.0))
    rng = np.random.default_rng(2)
    ui_w = np.zeros((h, w, 1), np.float32)
    ui_w[18:22, 26:30] = 1.0
    ui_v = np.broadcast_to(np.float32([0.8, -1.0]), (h, w, 2)).copy()
    v0 = (0.1 * rng.standard_normal((h, w, 2))).astype(np.float32)
    return dict(i0=i0, i1=i1, ui_w=ui_w, ui_v=ui_v), v0


@pytest.mark.parametrize(
    "overrides,field_atol",
    [
        (dict(), FIELD_ATOL),
        (dict(relin_every=1, relin_median=False), 1e-2),
        (dict(n_colors=4, fold_margin=0.3), FIELD_ATOL),
    ],
)
def test_level_solver_matches_reference(level_case, overrides, field_atol):
    arrs, v0 = level_case
    jp = JaxMorphParams(**overrides)
    n_iters = 20
    data = make_level_data(*(jnp.asarray(arrs[k]) for k in ("i0", "i1", "ui_w", "ui_v")))
    v_ref, st_ref = jax.jit(jd.make_level_solver(jp, n_iters))(jnp.asarray(v0), data)
    v_got, st_got = td.make_level_solver(_port(jp), n_iters)(
        torch.from_numpy(v0), level_data_from_numpy(**arrs)
    )
    _assert_stats(st_ref, st_got)
    hist_ref = np.asarray(st_ref.energy_history)
    hist_got = st_got.energy_history.numpy()
    np.testing.assert_array_equal(np.isnan(hist_ref), np.isnan(hist_got))
    np.testing.assert_allclose(hist_got, hist_ref, rtol=1e-3)
    assert np.max(np.abs(np.asarray(v_ref) - v_got.numpy())) <= field_atol


def test_level_solver_zero_iterations(level_case):
    arrs, v0 = level_case
    jp = JaxMorphParams()
    data = make_level_data(*(jnp.asarray(arrs[k]) for k in ("i0", "i1", "ui_w", "ui_v")))
    v_ref, st_ref = jd.make_level_solver(jp, 0)(jnp.asarray(v0), data)
    v_got, st_got = td.make_level_solver(_port(jp), 0)(torch.from_numpy(v0), level_data_from_numpy(**arrs))
    _assert_stats(st_ref, st_got)
    assert st_got.e0 == st_got.e_final
    np.testing.assert_array_equal(np.asarray(v_ref), v_got.numpy())


def test_masks_and_foldover(level_case):
    _, v0 = level_case
    h, w = v0.shape[:2]
    np.testing.assert_array_equal(np.asarray(jd.boundary_mask(h, w)), td.boundary_mask(h, w).numpy())
    for n_colors in (1, 2, 4):
        for color in range(n_colors):
            np.testing.assert_array_equal(
                np.asarray(jd.color_mask(h, w, jnp.int32(color), n_colors)),
                td.color_mask(h, w, color, n_colors).numpy(),
            )
    d = (3.0 * np.random.default_rng(5).standard_normal((h, w, 2))).astype(np.float32)
    ref = jd.foldover_scale(jnp.asarray(v0), jnp.asarray(d), 0.45)
    got = td.foldover_scale(torch.from_numpy(v0), torch.from_numpy(d), 0.45)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


def test_optimize_pair_matches_reference():
    h, w = 96, 128
    i0 = _texture(h, w, 3)
    i1 = _texture(h, w, 3, (2.0, 3.0))
    pts = np.array([[[30.0, 40.0], [32.0, 43.0]], [[60.0, 90.0], [62.0, 93.0]]], np.float32)
    jp = JaxMorphParams(iters_coarse=8, iters_fine=4)
    ref = jax_optimize_pair(jnp.asarray(i0), jnp.asarray(i1), jnp.asarray(pts), jp)
    got = optimize_pair(torch.from_numpy(i0), torch.from_numpy(i1), torch.from_numpy(pts), _port(jp))
    assert got.n_levels == ref.n_levels == 3
    assert len(got.level_stats) == len(ref.level_stats)
    for lvl, (s_ref, s_got) in enumerate(zip(ref.level_stats, got.level_stats)):
        _assert_stats(s_ref, s_got, 1e-5 if lvl == 0 else 1e-3)
    assert tuple(got.v.shape) == (h, w, 2)
    assert np.max(np.abs(np.asarray(ref.v) - got.v.numpy())) <= FIELD_ATOL
