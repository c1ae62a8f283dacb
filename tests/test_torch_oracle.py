"""The port's exact-oracle surface against the reference's.

- ``config.exact_configs`` returns the reference's three configurations
  value for value, and reverts every speed knob (the twin of
  ``tests/test_exact_oracle.py``'s knob test);
- ``solver.descent.warp_bundle`` equals the reference's on a 24 x 32 level
  within 1e-6 of each plane's max (the same float32 bilinear operations),
  and ``energy_value_grad_precond`` within the sweep tolerances: energy
  1e-5 relative, gradient and preconditioner 1e-5 of their max (other
  summation orders);
- the port's ``WarpBundle`` fields are views of kernel 3's plane stack,
  and the level solver's first energy is ``energy_value_grad_precond``'s
  at its start, bitwise (the same warp and sweep), with one re-warp per
  ``relin_every`` iterations.
"""

import dataclasses

import numpy as np
import pytest
import torch

import videomorphing_tpu.config as jconfig
from videomorphing_tpu.solver import descent as jd
from videomorphing_tpu.solver.energy import make_level_data as jax_make_level_data
from videomorphing_tpu_torch import config as tconfig
from videomorphing_tpu_torch.interop import level_data_from_numpy
from videomorphing_tpu_torch.kernels.warp import bundle_from_planes, halfway_warp_plain
from videomorphing_tpu_torch.solver import descent as td

torch.set_num_threads(1)


def test_exact_configs_match_reference():
    for ref, got in zip(jconfig.exact_configs(), tconfig.exact_configs()):
        assert type(got).__name__ == type(ref).__name__
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_exact_configs_revert_every_speed_knob():
    mp, sp, vp = tconfig.exact_configs()
    assert mp.backend == "jnp" and not mp.fused_warp
    assert mp.relin_every == 1 and mp.pack_dtype == "float32"
    assert mp.relin_median is False
    assert sp.invert_multiscale is False and sp.fused_sampling is False
    assert vp.flow_scale == 1.0 and vp.advect_scale == 1.0
    assert vp.flow_warps >= 3 and vp.flow_iters >= 60
    assert vp.warm_relin_every == 1


@pytest.fixture(scope="module")
def level():
    rng = np.random.default_rng(11)
    h, w = 24, 32
    i0 = rng.random((h, w, 3), dtype=np.float32)
    i1 = rng.random((h, w, 3), dtype=np.float32)
    ui_w = rng.random((h, w, 1), dtype=np.float32)
    ui_v = (rng.standard_normal((h, w, 2))).astype(np.float32)
    tc_w = rng.random((h, w, 1), dtype=np.float32)
    tc_v = (rng.standard_normal((h, w, 2))).astype(np.float32)
    v = (1.5 * rng.standard_normal((h, w, 2))).astype(np.float32)
    args = (i0, i1, ui_w, ui_v, tc_w, tc_v)
    return jax_make_level_data(*args), level_data_from_numpy(*args), v


def _max_rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = got.detach().numpy().astype(np.float64)
    assert ref.shape == got.shape
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-30))


def test_warp_bundle_matches_reference(level):
    jdata, tdata, v = level
    ref = jd.warp_bundle(v, jdata)
    got = td.warp_bundle(torch.from_numpy(v), tdata)
    for name in ("v_lin", "w0", "dw0", "w1", "dw1"):
        assert _max_rel(getattr(ref, name), getattr(got, name)) <= 1e-6, name
    planes = halfway_warp_plain(tdata.i0, tdata.i1, torch.from_numpy(v))
    for field, ref_field in zip(got[1:], bundle_from_planes(planes)):
        assert torch.equal(field, ref_field)


@pytest.mark.parametrize("overrides", [{}, dict(ssim_window=7, ssim_sigma=1.5, ssim_use_luminance=False)])
def test_energy_value_grad_precond_matches_reference(level, overrides):
    jdata, tdata, v = level
    e_r, g_r, p_r = jd.energy_value_grad_precond(v, jdata, jconfig.MorphParams(**overrides))
    e_g, g_g, p_g = td.energy_value_grad_precond(torch.from_numpy(v), tdata, tconfig.MorphParams(**overrides))
    assert e_g.dim() == 0
    assert abs(float(e_g) - float(e_r)) <= 1e-5 * abs(float(e_r))
    assert _max_rel(g_r, g_g) <= 1e-5 and _max_rel(p_r, p_g) <= 1e-5


def test_level_solver_starts_at_energy_value_grad_precond(level, monkeypatch):
    _, tdata, v = level
    p = tconfig.MorphParams(relin_every=3)
    e_start = float(np.float32(td.energy_value_grad_precond(torch.from_numpy(v), tdata, p)[0].item()))
    calls = []
    real = td.halfway_warp
    monkeypatch.setattr(td, "halfway_warp", lambda *a: calls.append(1) or real(*a))
    v_out, st = td.make_level_solver(p, 7)(torch.from_numpy(v), tdata)
    assert st.e0 == e_start
    assert st.iters == 7 and len(calls) == 3
    assert torch.isfinite(v_out).all()
