"""The port's golden cases (``utils.golden``) against the reference's.

- ``translation_case``, ``rotation_case`` and ``scale_case`` equal the
  reference's within 1e-6 when both get the reference's ``jax.random``
  draws (the port's own draws come from numpy); the crop margins are
  equal;
- the analytic constructions hold in the port: a zero shift gives i0 =
  i1 = mid, and p -/+ v_true carry i0 and i1 to the same texture point
  (bilinear noise only, the reference's 2e-2);
- ``run_golden`` at 64 x 64 (2 levels of 20 iterations) agrees with the
  reference's: SSIM within 1e-4 and field errors within 2e-3 px, the drift
  of two levels of 20 float32 iterations (ROADMAP §3: ~1e-3 px each);
- the gate (``tests/test_golden.py``, thresholds of BASELINE's 0.99) on
  the port's own textures at 128 x 128, 4 levels.
"""

import jax
import numpy as np
import pytest
import torch

from videomorphing_tpu.config import MorphParams as JaxMorphParams
from videomorphing_tpu.utils import golden as jg
from videomorphing_tpu_torch.config import MorphParams
from videomorphing_tpu_torch.ops.resample import bilinear_sample, grid_coords
from videomorphing_tpu_torch.utils import golden as tg

torch.set_num_threads(2)
SEEDS = {"translation": 0, "rotation": 1, "scale": 2}


def jax_texture_params(key, channels=3, n_waves=24, min_period=10.0, max_period=80.0):
    """The reference's draws for one ``_texture`` call under ``key``."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    s = (channels, n_waves)
    return tuple(np.asarray(a) for a in (
        jax.random.uniform(k1, s, minval=float(np.log(min_period)), maxval=float(np.log(max_period))),
        jax.random.uniform(k2, s, minval=0.0, maxval=2.0 * np.pi),
        jax.random.uniform(k3, s, minval=0.0, maxval=2.0 * np.pi),
        jax.random.uniform(k4, s, minval=0.5, maxval=1.0),
    ))


@pytest.mark.parametrize("case", sorted(SEEDS))
def test_cases_match_reference(case):
    seed = SEEDS[case]
    ref = getattr(jg, case + "_case")(72, 96, seed=seed)
    got = getattr(tg, case + "_case")(72, 96, seed=seed, params=jax_texture_params(jax.random.PRNGKey(seed)),
                                      device="cpu")
    assert got.crop == ref.crop
    for name in ("i0", "i1", "mid_true", "v_true"):
        r, g = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        assert g.shape == r.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-6, err_msg=name)


def test_translation_case_is_exact():
    g = tg.translation_case(64, 64, shift=(2.0, 3.0), device="cpu")
    g0 = tg.translation_case(64, 64, shift=(0.0, 0.0), device="cpu")
    torch.testing.assert_close(g0.i1, g0.i0, rtol=0, atol=1e-6)
    torch.testing.assert_close(g0.mid_true, g0.i0, rtol=0, atol=1e-6)
    assert g.v_true[10, 10].tolist() == [2.0, 3.0]
    assert float(g.i0.min()) >= 0.0 and float(g.i0.max()) <= 1.0


@pytest.mark.parametrize("case,kw", [("rotation", dict(theta=0.03)), ("scale", dict(k=1.12))])
def test_v_true_is_consistent(case, kw):
    g = getattr(tg, case + "_case")(96, 96, device="cpu", **kw)
    grid = grid_coords(96, 96)
    w0 = bilinear_sample(g.i0, grid - g.v_true)
    w1 = bilinear_sample(g.i1, grid + g.v_true)
    c = g.crop
    assert float((w0 - w1)[c:-c, c:-c].abs().max()) < 2e-2
    if case == "scale":
        assert float((w0 - g.mid_true)[c:-c, c:-c].abs().max()) < 2e-2


def test_texture_params_draw_from_numpy():
    a = tg.texture_params(5)
    b = tg.texture_params(np.random.default_rng(5))
    assert all(np.array_equal(x, y) and x.shape == (3, 24) and x.dtype == np.float32 for x, y in zip(a, b))
    log_period, ang, psi, amp = a
    assert np.log(10.0) <= log_period.min() and log_period.max() < np.log(80.0)
    assert 0.0 <= ang.min() and psi.max() < 2 * np.pi and 0.5 <= amp.min() and amp.max() < 1.0


@pytest.mark.parametrize("case", sorted(SEEDS))
def test_run_golden_matches_reference(case):
    seed = SEEDS[case]
    kw = dict(n_levels=2, iters_coarse=20, iters_fine=20)
    ref = jg.run_golden(case, hw=(64, 64), mp=JaxMorphParams(**kw), seed=seed)
    got = tg.run_golden(case, hw=(64, 64), mp=MorphParams(**kw), seed=seed,
                        params=jax_texture_params(jax.random.PRNGKey(seed)), device="cpu")
    assert got.keys() == ref.keys() and got["case"] == case and got["crop"] == ref["crop"]
    assert abs(got["ssim_mid"] - ref["ssim_mid"]) <= 1e-4, (got, ref)
    for k in ("v_err_mean", "v_err_p99"):
        assert abs(got[k] - ref[k]) <= 2e-3, (k, got, ref)


@pytest.mark.parametrize("case", sorted(SEEDS))
def test_golden_gate(case):
    r = tg.run_golden(case, hw=(128, 128), mp=MorphParams(n_levels=4), device="cpu")
    assert r["ssim_mid"] >= 0.99, r
    if case == "translation":
        assert r["v_err_mean"] < 0.1, r
    with pytest.raises(ValueError, match="unknown golden case"):
        tg.run_golden("shear", device="cpu")
