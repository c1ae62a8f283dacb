"""Port parity: the warm-started pair solve and its inputs.

- ``ops.pyramid.downsample_to`` against the reference on seeded inputs
  (3-channel, 1-channel and 2-D), max abs <= 1e-6 (values in [0, 1]; one
  float32 resize whose sums run in another order);
- ``solver.ctf.optimize_pair`` with ``v0``, ``tc_w``/``tc_v`` and
  ``start_level``, on ``test_torch_solver.py``'s textured 96 x 128 pair
  (3 levels, 2 points), from the reference's cold field carried across as
  ``v0``: the same levels and
  iteration counts, the field within 1e-3 px, the pair-solve tolerance of
  ``test_torch_pair.py`` / ``test_torch_solver.py`` (float32 solver drift);
- ``ImageMorpher.solve(..., v0=)`` and ``api.Session``'s warm restart;
- ``api.morph_clips`` accepts ``mesh=None`` and raises on a mesh.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from videomorphing_tpu import api as jax_api
from videomorphing_tpu.config import MorphParams as JaxMorphParams
from videomorphing_tpu.models.image_morph import ImageMorpher as JaxImageMorpher
from videomorphing_tpu.ops import pyramid as jpyr
from videomorphing_tpu.solver.ctf import optimize_pair as jax_optimize_pair
from videomorphing_tpu_torch import api
from videomorphing_tpu_torch.config import MorphParams
from videomorphing_tpu_torch.models.image_morph import ImageMorpher
from videomorphing_tpu_torch.ops import pyramid as tpyr
from videomorphing_tpu_torch.solver.ctf import optimize_pair

torch.set_num_threads(2)
H, W = 96, 128
FIELD_ATOL = 1e-3
JMP = JaxMorphParams(iters_coarse=8, iters_fine=4)
MP = MorphParams(**dataclasses.asdict(JMP))


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _maxabs(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b.detach().numpy() if isinstance(b, torch.Tensor) else b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)))


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


@pytest.fixture(scope="module")
def pair():
    pts = np.array([[[30.0, 40.0], [32.0, 43.0]], [[60.0, 90.0], [62.0, 93.0]]], np.float32)
    return _texture(H, W, 3), _texture(H, W, 3, (2.0, 3.0)), pts


@pytest.fixture(scope="module")
def cold(pair):
    """The reference's cold field, the warm start of every case below."""
    i0, i1, pts = pair
    res = jax_optimize_pair(jnp.asarray(i0), jnp.asarray(i1), jnp.asarray(pts), JMP)
    assert res.n_levels == 3
    return np.asarray(res.v)


@pytest.mark.parametrize(
    "shape,hw",
    [((37, 53, 3), (9, 13)), ((64, 96, 1), (15, 22)), ((40, 56), (20, 28)), ((200, 120, 2), (11, 7))],
)
def test_downsample_to_matches_reference(shape, hw):
    x = np.random.default_rng(len(shape) + shape[0]).random(shape, dtype=np.float32)
    ref = jpyr.downsample_to(jnp.asarray(x), hw)
    got = tpyr.downsample_to(_t(x), hw)
    assert tuple(got.shape) == tuple(ref.shape)
    assert _maxabs(ref, got) <= 1e-6


def _compare(ref, got):
    assert got.n_levels == ref.n_levels
    assert [s.iters for s in got.level_stats] == [int(s.iters) for s in ref.level_stats]
    assert _maxabs(ref.v, got.v) <= FIELD_ATOL


def test_warm_start_from_reference_field(pair, cold):
    """``v0`` alone: the solve starts at the middle level (1 of 0..2)."""
    i0, i1, pts = pair
    ref = jax_optimize_pair(jnp.asarray(i0), jnp.asarray(i1), jnp.asarray(pts), JMP, v0=jnp.asarray(cold))
    got = optimize_pair(_t(i0), _t(i1), _t(pts), MP, v0=_t(cold))
    assert len(got.level_stats) == 2
    _compare(ref, got)


def test_warm_start_with_temporal_coherence(pair, cold):
    """``v0`` with a 2-D ``tc_w`` (brought down per level with
    ``downsample_to``) and a ``tc_v`` near the field."""
    i0, i1, pts = pair
    rng = np.random.default_rng(3)
    tc_w = rng.random((H, W), dtype=np.float32)
    tc_v = (cold + 0.3 * rng.standard_normal(cold.shape)).astype(np.float32)
    ref = jax_optimize_pair(
        jnp.asarray(i0), jnp.asarray(i1), jnp.asarray(pts), JMP,
        v0=jnp.asarray(cold), tc_w=jnp.asarray(tc_w), tc_v=jnp.asarray(tc_v),
    )
    got = optimize_pair(_t(i0), _t(i1), _t(pts), MP, v0=_t(cold), tc_w=_t(tc_w), tc_v=_t(tc_v))
    _compare(ref, got)


@pytest.mark.parametrize("start_level,with_v0", [(0, True), (2, True), (7, False)])
def test_start_level(pair, cold, start_level, with_v0):
    """An explicit ``start_level`` (clamped to the coarsest), warm or cold."""
    i0, i1, pts = pair
    v0 = cold if with_v0 else None
    ref = jax_optimize_pair(
        jnp.asarray(i0), jnp.asarray(i1), jnp.asarray(pts), JMP,
        v0=None if v0 is None else jnp.asarray(v0), start_level=start_level,
    )
    got = optimize_pair(_t(i0), _t(i1), _t(pts), MP, v0=None if v0 is None else _t(v0), start_level=start_level)
    assert len(got.level_stats) == min(start_level, 2) + 1
    _compare(ref, got)


def test_image_morpher_solve_with_v0(pair, cold):
    i0, i1, pts = pair
    ref = JaxImageMorpher(JMP).solve(jnp.asarray(i0), jnp.asarray(i1), jnp.asarray(pts), v0=jnp.asarray(cold))
    got = ImageMorpher(MP).solve(_t(i0), _t(i1), _t(pts), v0=_t(cold))
    assert _maxabs(ref.v, got.v) <= FIELD_ATOL
    assert _maxabs(ref.b, got.b) <= FIELD_ATOL
    assert len(got.result.level_stats) == 2


def test_session_warm_restart(pair):
    """The first ``update_points`` solves cold (as the reference's), the
    next warm-starts from the current field; ``preview``/``render``
    render the current artifacts."""
    i0, i1, pts = pair
    ref = jax_api.Session(i0, i1, JMP)
    sess = api.Session(i0, i1, MP)
    assert sess.solve() is sess.art and sess.art.result.n_levels == 3
    sess.art = None
    first = sess.update_points(pts)
    assert len(first.result.level_stats) == 3
    assert _maxabs(ref.update_points(pts).v, first.v) <= FIELD_ATOL
    moved = pts + np.float32(1.0)
    second = sess.update_points(moved)
    assert len(second.result.level_stats) == 2
    again = ImageMorpher(MP).solve(sess.i0, sess.i1, _t(moved), v0=first.v)
    assert torch.equal(second.v, again.v)
    frame = sess.preview(0.5)
    assert torch.equal(frame, ImageMorpher(MP).render_one(sess.i0, sess.i1, second, 0.5))
    frames = sess.render(3)
    assert frames.shape == (3, H, W, 3)
    assert torch.equal(frames[1], frame)


def test_morph_clips_accepts_mesh_none():
    ca, cb = bench._make_clips(2, 16, 24, seed=0)
    res = api.morph_clips(ca, cb, mp=MP, render=False, mesh=None, device="cpu")
    assert res.fields.shape == (2, 16, 24, 2)
    with pytest.raises(NotImplementedError, match="item 16"):
        api.morph_clips(ca, cb, mp=MP, render=False, mesh=object(), device="cpu")
