"""Port parity: the mesh, the halo exchange, the row-shard sweep kernels'
plain versions and the row-sharded solves (``parallel/``).

The reference runs on ``make_mesh((4,), ("y",))`` from the 8 virtual CPU
devices, the port on ``make_mesh((4,), ("y",), devices=["cpu"] * 4)``; the
inputs are seeded numpy in both. Tolerances are the reference's own
(``tests/test_parallel.py``):

- the halo exchange: equal to the zero-padded global slices and to the
  reference's ``halo_exchange_rows`` under ``shard_map``;
- the shard sweep plain versions against the reference's
  ``fused_grad_parts_shard`` / ``fused_energy_parts_shard`` (interpret
  mode) on each extended block of a 64 x 48, C = 3 level split 4 ways: grad
  and precond within 1e-5 of max|ref|, each raw partial within 1e-5
  relative;
- ``make_spatial_level_solver`` (64 x 48, 4 blocks, 6 iterations) against
  the reference's, and against the port's single-device
  ``make_level_solver``: v within 2e-3, e0 within 1e-5 relative, e_final
  within 1e-4 relative (float32 sums in another order, compounded over the
  iterations);
- the row-sharded solver's pieces: each row block's boundary and colour
  masks are the frame's at its rows (1, 2, 4 colours; 2-4 blocks), the
  foldover clamp on an extended block is the frame's clamp at the owned
  rows, bitwise, and a solve is one ``solve.level`` span whose ``iters``
  and ``armijo_trials`` are its ``LevelStats.iters`` and its kernel-2
  shard calls over the blocks;
- ``optimize_pair_spatial`` (2 levels, 64 x 48): p99 of |dv| below 5e-3 and
  max below 0.05 against the reference (an Armijo test may flip at
  isolated pixels; a halo or seam fault shifts whole bands).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from videomorphing_tpu.config import MorphParams as JaxMorphParams
from videomorphing_tpu.ops.resample import bilinear_sample_with_grad as jax_sample_with_grad
from videomorphing_tpu.ops.windows import gaussian_kernel_1d as jax_gaussian
from videomorphing_tpu.pallas import sweep as jsw
from videomorphing_tpu.parallel.halo import halo_exchange_rows as jax_halo_exchange
from videomorphing_tpu.parallel.mesh import make_mesh as jax_make_mesh
from videomorphing_tpu.parallel.spatial import make_spatial_level_solver as jax_spatial_solver
from videomorphing_tpu.parallel.spatial import optimize_pair_spatial as jax_optimize_pair_spatial
from videomorphing_tpu.solver.energy import make_level_data as jax_level_data
from videomorphing_tpu_torch import api
from videomorphing_tpu_torch.config import MorphParams
from videomorphing_tpu_torch.interop import level_data_from_numpy
from videomorphing_tpu_torch.kernels import sweep as ks
from videomorphing_tpu_torch.kernels import warp as kw
from videomorphing_tpu_torch.models.image_morph import ImageMorpher
from videomorphing_tpu_torch.models.video_morph import VideoMorpher
from videomorphing_tpu_torch.parallel import mesh as pm
from videomorphing_tpu_torch.parallel import spatial
from videomorphing_tpu_torch.parallel.halo import halo_exchange_rows
from videomorphing_tpu_torch.parallel.spatial import (
    exchange_halo,
    level_is_sharded,
    make_spatial_level_solver,
    optimize_pair_spatial,
)
from videomorphing_tpu_torch.solver import descent
from videomorphing_tpu_torch.solver.descent import make_level_solver
from videomorphing_tpu_torch.solver.energy import LevelData
from videomorphing_tpu_torch.utils import profiling

torch.set_num_threads(2)
N_DEV = 4
H, W = 64, 48


def _smooth(rng, h, w, c=3):
    img = jnp.asarray(rng.random((h, w, c), dtype=np.float32))
    k = jax_gaussian(5, 1.5)
    from videomorphing_tpu.ops.windows import separable_filter

    return np.asarray(separable_filter(img, k, k, mode="same_edge"))


def _cpu_mesh(n=N_DEV):
    return pm.make_mesh((n,), ("y",), devices=["cpu"] * n)


@pytest.fixture(scope="module")
def jmesh():
    return jax_make_mesh((N_DEV,), ("y",))


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    return _smooth(rng, H, W), _smooth(rng, H, W)


# ---------------------------------------------------------------- mesh, halo


def test_make_mesh_lists_devices():
    mesh = pm.make_mesh((2, 2), ("batch", "y"), devices=["cpu"] * 5)
    assert mesh.shape == {"batch": 2, "y": 2} and len(mesh.devices) == 4
    assert all(d == torch.device("cpu") for d in mesh.devices)
    assert _cpu_mesh().axis_devices("y") == (torch.device("cpu"),) * N_DEV
    assert mesh.axis_devices("y") == mesh.axis_devices("batch") == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="need 4 devices"):
        pm.make_mesh((4,), devices=["cpu"] * 3)
    with pytest.raises(TypeError, match="Mesh"):
        pm.as_mesh(object())


def test_make_mesh_defaults_to_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.make_mesh()


@pytest.mark.parametrize("halo", [1, 2, 6])
def test_halo_exchange_matches_global_and_reference(jmesh, halo):
    bh = 8
    x = np.arange(N_DEV * bh * 6, dtype=np.float32).reshape(N_DEV * bh, 6)
    blocks = [torch.from_numpy(x[k * bh:(k + 1) * bh]) for k in range(N_DEV)]
    got = halo_exchange_rows(blocks, halo)
    xp = np.pad(x, ((halo, halo), (0, 0)))
    ref = jax.shard_map(
        lambda b: jax_halo_exchange(b, halo, "y"), mesh=jmesh, in_specs=P("y"), out_specs=P("y"),
        check_vma=False,
    )(jnp.asarray(x))
    ref = np.asarray(ref).reshape(N_DEV, bh + 2 * halo, 6)
    for k in range(N_DEV):
        np.testing.assert_array_equal(got[k].numpy(), xp[k * bh:k * bh + bh + 2 * halo])
        np.testing.assert_array_equal(got[k].numpy(), ref[k])


# ------------------------------------------------------ shard sweep kernels


@pytest.mark.parametrize("luminance", [True, False])
def test_ssim_valid_matches_reference(luminance):
    """``valid=`` of ``ssim_parts`` and the gradient bundle (the extended
    block's in-frame rows) against the reference's, within 1e-5 of
    max|ref|."""
    from videomorphing_tpu.ops import ssim as jss
    from videomorphing_tpu_torch.ops import ssim as tss

    rng = np.random.default_rng(7)
    w0, w1 = rng.random((2, 20, 24, 3), dtype=np.float32)
    valid = np.zeros((20, 24, 1), np.float32)
    valid[4:15] = 1.0
    ref_parts = jss.ssim_parts(jnp.asarray(w0), jnp.asarray(w1), valid=jnp.asarray(valid))
    got_parts = tss.ssim_parts(torch.from_numpy(w0), torch.from_numpy(w1), valid=torch.from_numpy(valid))
    ref = jss._dssim_grad_impl(jnp.asarray(w0), jnp.asarray(w1), 5, 1.0, 1e-4, 9e-4, luminance,
                               valid=jnp.asarray(valid))
    got = tss.dssim_grad_bundle(torch.from_numpy(w0), torch.from_numpy(w1), use_luminance=luminance,
                                valid=torch.from_numpy(valid))
    pairs = [(ref_parts[k], got_parts[k]) for k in ref_parts] + list(zip(ref, got))
    for r, g in pairs:
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= 1e-5 * max(np.abs(r).max(), 1e-30)


def _ref_shard_call(i0, i1, v_lin, v, maps, k, p):
    """The reference's Pallas shard path (parallel/spatial.py:241-287) on
    block k: the pack of the trimmed extended block, then both shard
    kernels in interpret mode."""
    hh, ww, c = i0.shape
    bh = hh // N_DEV
    halo = 2 * (p.ssim_window // 2) + 2
    rh = jsw.sweep_row_halo(p)
    off = halo - rh
    he_t = bh + 2 * rh
    ys_t = np.arange(he_t)[:, None] + (k * bh - rh) + np.zeros((1, ww), np.int64)
    xs_t = np.zeros((he_t, 1), np.int64) + np.arange(ww)[None, :]
    vld_t = ((ys_t >= 0) & (ys_t < hh)).astype(np.float32)
    taps = np.asarray(jax_gaussian(p.ssim_window, p.ssim_sigma))
    rr = p.ssim_window // 2
    ny = np.zeros(ys_t.shape, np.float32)
    for t in range(p.ssim_window):
        ok = ((ys_t + (t - rr)) >= 0) & ((ys_t + (t - rr)) < hh)
        ny = ny + taps[t] * ok.astype(np.float32)
    nx = np.convolve(np.ones((ww,), np.float32), taps, mode="same").astype(np.float32)
    n_t = ny * nx[None, :]
    invn_t = np.where(vld_t > 0, 1.0 / np.where(vld_t > 0, n_t, 1.0), 0.0).astype(np.float32)
    rows_t = np.arange(he_t)[:, None]
    ew_t = ((rows_t >= rh) & (rows_t < rh + bh)).astype(np.float32) * vld_t
    g_t = jnp.asarray(np.stack([ys_t, xs_t], -1).astype(np.float32))
    m3 = jnp.asarray(vld_t[..., None])

    def ext(a):
        return jnp.asarray(np.pad(a, ((halo, halo), (0, 0), (0, 0)))[k * bh + off:k * bh + off + he_t])

    vl_t, v_t = ext(v_lin), ext(v)
    w0, dw0 = jax_sample_with_grad(jnp.asarray(i0), g_t - vl_t)
    w1, dw1 = jax_sample_with_grad(jnp.asarray(i1), g_t + vl_t)
    blk = [jnp.asarray(m[k * bh:(k + 1) * bh]) for m in maps]
    x_static = jsw.make_sweep_pack_shard(
        w0 * m3, dw0 * m3[..., None], w1 * m3, dw1 * m3[..., None], vl_t, *blk,
        jnp.asarray(invn_t), jnp.asarray(vld_t), jnp.asarray(ew_t), p, rh,
    )
    xv = jsw.pack_v_shard(v_t, rh, p)
    parts, grad, precond = jsw.fused_grad_parts_shard(x_static, xv, (bh, ww), c, p, hh * ww, interpret=True)
    parts_e = jsw.fused_energy_parts_shard(x_static, xv, (bh, ww), c, p, hh * ww, interpret=True)
    return np.asarray(parts), np.asarray(grad), np.asarray(precond), np.asarray(parts_e)


@pytest.fixture(scope="module")
def shard_case(pair):
    rng = np.random.default_rng(3)
    i0, i1 = pair
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    v_lin = np.stack([1.5 * np.sin(yy / 9.0 + xx / 13.0), 2.0 * np.cos(xx / 11.0)], -1).astype(np.float32)
    v = (v_lin + 0.1 * rng.standard_normal((H, W, 2))).astype(np.float32)
    maps = (
        rng.random((H, W, 1), dtype=np.float32),
        (v + 0.1 * rng.standard_normal((H, W, 2))).astype(np.float32),
        rng.random((H, W, 1), dtype=np.float32),
        (v + 0.5 * rng.standard_normal((H, W, 2))).astype(np.float32),
    )
    return i0, i1, v_lin, v, maps


def _port_shard_call(i0, i1, v_lin, v, maps, k, p):
    bh = H // N_DEV
    halo = exchange_halo(p)
    t = lambda a: torch.from_numpy(np.array(a))
    ext = lambda a: t(np.pad(a, ((halo, halo), (0, 0), (0, 0)))[k * bh:k * bh + bh + 2 * halo])
    row0 = k * bh - halo
    vl_e, v_e = ext(v_lin), ext(v)
    planes = kw.halfway_warp_rows(t(i0), t(i1), vl_e, row0)
    data = LevelData(t(i0), t(i1), *(t(m[k * bh:(k + 1) * bh]) for m in maps))
    parts, grad, precond = ks.sweep_grad_shard(planes, vl_e, v_e, data, p, row0, H, halo)
    parts_e = ks.sweep_energy_shard(planes, vl_e, v_e, data, p, row0, H, halo)
    return parts.numpy(), grad.numpy(), precond.numpy(), parts_e.numpy()


@pytest.mark.parametrize("block", range(N_DEV))
def test_shard_sweep_plain_matches_reference_kernels(shard_case, block):
    jp_ = JaxMorphParams(backend="pallas", lambda_tps=0.01)
    p = MorphParams(lambda_tps=0.01)
    ref = _ref_shard_call(*shard_case, block, jp_)
    got = _port_shard_call(*shard_case, block, p)
    for name, r, g in zip(("parts", "grad", "precond", "energy parts"), ref, got):
        assert r.shape == g.shape, (name, r.shape, g.shape)
        if "parts" in name:
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=0, err_msg=name)
        else:
            assert np.abs(g - r).max() <= 1e-5 * np.abs(r).max(), name


def test_row_offset_warp_is_the_whole_warp_rows(shard_case):
    """Kernel 3's row-offset form (plain version here) equals the whole
    warp's rows bitwise, with zero planes outside the frame."""
    i0, i1, v_lin, _, _ = shard_case
    t = lambda a: torch.from_numpy(np.array(a))
    whole = kw.halfway_warp(t(i0), t(i1), t(v_lin))
    for row0, rows in ((-6, 28), (10, 20), (50, 20)):
        lo, hi = max(row0, 0), min(row0 + rows, H)
        v = np.zeros((rows, W, 2), np.float32)
        v[lo - row0:hi - row0] = v_lin[lo:hi]
        got = kw.halfway_warp_rows(t(i0), t(i1), t(v), row0)
        assert torch.equal(got[:, lo - row0:hi - row0], whole[:, lo:hi])
        inside = torch.zeros(rows, dtype=torch.bool)
        inside[lo - row0:hi - row0] = True
        assert torch.count_nonzero(got[:, ~inside]) == 0
    assert kw.halfway_warp.launches == 0 and kw.halfway_warp_rows.launches == 0


def test_shard_forms_check_their_halo(shard_case):
    i0, i1, v_lin, v, maps = shard_case
    p = MorphParams()
    t = lambda a: torch.from_numpy(np.array(a))
    short = t(v[:20])
    data = LevelData(t(i0), t(i1), *(t(m[:16]) for m in maps))
    with pytest.raises(ValueError, match="halo"):
        ks.sweep_energy_shard(kw.halfway_warp_rows(t(i0), t(i1), short, 0), short, short, data, p, 0, H, 2)
    for fn in (ks.sweep_grad_shard, ks.sweep_energy_shard):
        assert fn.launches == 0


# ----------------------------------------------------- the sharded solves


SOLVER_CASES = {
    "jnp_colors1": dict(n_colors=1, lambda_tps=0.01, backend="jnp"),
    "jnp_colors2": dict(n_colors=2, lambda_tps=0.01, backend="jnp"),
    "pallas": dict(lambda_tps=0.01, backend="pallas"),
    "median_jnp": dict(relin_median=True, relin_every=2, backend="jnp"),
    "median_pallas": dict(relin_median=True, relin_every=2, backend="pallas"),
}


def _check_level(v_ref, st_ref, v, st):
    np.testing.assert_allclose(float(st.e0), float(st_ref.e0), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(v), np.asarray(v_ref), atol=2e-3, rtol=0)
    np.testing.assert_allclose(float(st.e_final), float(st_ref.e_final), rtol=1e-4)


@pytest.mark.parametrize("case", list(SOLVER_CASES))
def test_spatial_level_solver_matches_reference(pair, jmesh, case):
    kw_ = SOLVER_CASES[case]
    i0, i1 = pair
    v0 = np.zeros((H, W, 2), np.float32)
    jp_ = JaxMorphParams(**kw_)
    v_ref, st_ref = jax_spatial_solver(jp_, 6, jmesh, axis="y")(
        jnp.asarray(v0), jax_level_data(jnp.asarray(i0), jnp.asarray(i1))
    )
    p = MorphParams(**kw_)
    v, st = make_spatial_level_solver(p, 6, _cpu_mesh())(torch.from_numpy(v0), level_data_from_numpy(i0, i1))
    assert st.iters == int(st_ref.iters) == 6
    _check_level(v_ref, st_ref, v, st)


@pytest.mark.parametrize("case", ["jnp_colors1", "median_jnp"])
def test_spatial_level_solver_matches_single_device(pair, case):
    i0, i1 = pair
    p = MorphParams(**SOLVER_CASES[case])
    data = level_data_from_numpy(i0, i1)
    v0 = torch.zeros((H, W, 2))
    v_ref, st_ref = make_level_solver(p, 6)(v0, data)
    v, st = make_spatial_level_solver(p, 6, _cpu_mesh())(v0, data)
    _check_level(v_ref, st_ref, v, st)


def test_spatial_level_solver_rejects_short_blocks(pair):
    i0, i1 = pair
    data = level_data_from_numpy(i0[:20], i1[:20])
    with pytest.raises(ValueError, match="blocks"):
        make_spatial_level_solver(MorphParams(), 2, _cpu_mesh())(torch.zeros((20, W, 2)), data)


@pytest.mark.parametrize("n_colors", [1, 2, 4])
@pytest.mark.parametrize("n_blocks", [2, 3, 4])
def test_block_masks_are_the_frame_masks_at_its_rows(pair, n_colors, n_blocks):
    i0, i1 = pair
    h = 48  # divides into 2, 3 and 4 blocks of at least the halo
    data = level_data_from_numpy(i0[:h], i1[:h])
    rows = spatial._RowBlocks(MorphParams(n_colors=n_colors), ["cpu"] * n_blocks, torch.zeros((h, W, 2)), data,
                              torch.float32)
    bh = h // n_blocks
    assert len(rows.blocks) == n_blocks and len(rows.v_blks) == n_blocks
    for k, b in enumerate(rows.blocks):
        own = slice(k * bh, (k + 1) * bh)
        assert torch.equal(b.bmask, descent.boundary_mask(h, W)[own]), k
        assert len(b.cmasks) == n_colors
        for c, m in enumerate(b.cmasks):
            assert torch.equal(m, descent.color_mask(h, W, c, n_colors)[own]), (k, c)


@pytest.mark.parametrize("n_blocks", [2, 3, 4])
def test_extended_block_clamp_is_the_frame_clamp_at_its_rows(n_blocks):
    """``foldover_scale`` on a block's extended field (zero rows beyond the
    frame) clamps a boundary-locked step as the frame's clamp does at the
    owned rows, bitwise."""
    rng = np.random.default_rng(11)
    h, w, halo = 48, 20, exchange_halo(MorphParams())
    v = torch.from_numpy((0.4 * rng.standard_normal((h, w, 2))).astype(np.float32))
    d = torch.from_numpy(rng.standard_normal((h, w, 2)).astype(np.float32)) * descent.boundary_mask(h, w)
    want = descent.foldover_scale(v, d, 0.4)
    assert not torch.equal(want, d)  # the clamp bites
    bh = h // n_blocks
    v_ext = halo_exchange_rows([v[k * bh:(k + 1) * bh] for k in range(n_blocks)], halo)
    for k, ve in enumerate(v_ext):
        own = slice(k * bh, (k + 1) * bh)
        assert torch.equal(descent.foldover_scale(ve, d[own], 0.4), want[own]), k


@pytest.mark.parametrize("case", ["jnp_colors2", "backtracks"])
def test_spatial_solve_opens_one_level_span(pair, monkeypatch, case):
    """A row-sharded solve is one ``solve.level`` span of ``descent.descend``:
    ``h``, ``w``, ``n_iters``, ``radius`` (window 5's 2), ``iters`` its
    ``LevelStats.iters``, and ``armijo_trials`` its kernel-2 shard calls
    over the blocks."""
    kw_ = dict(init_step=1e4, max_backtracks=2, backend="jnp") if case == "backtracks" else SOLVER_CASES[case]
    calls = {"n": 0}
    shard = spatial.sweep_energy_shard

    def counted(*args):
        calls["n"] += 1
        return shard(*args)

    monkeypatch.setattr(spatial, "sweep_energy_shard", counted)
    i0, i1 = pair
    profiling.clear()
    with profiling.record_phases():
        v, st = make_spatial_level_solver(MorphParams(**kw_), 6, _cpu_mesh())(
            torch.zeros((H, W, 2)), level_data_from_numpy(i0, i1))
    levels = [s for s in profiling.spans() if s.name == "solve.level"]
    profiling.clear()
    assert len(levels) == 1
    span = levels[0]
    assert span.attrs == {"h": H, "w": W, "n_iters": 6, "radius": 2, "iters": st.iters} and st.iters > 0
    assert span.counts["armijo_trials"] * N_DEV == calls["n"]
    assert span.counts["armijo_trials"] >= st.iters + (case == "backtracks")


# ------------------------------------------- the 2-D pairs x rows layout


def test_axis_devices_on_a_2d_mesh():
    """Along an axis at index 0 of the others (the reference's ``P(axis)``
    with replicas on the other axes), or at a given index."""
    devs = ["cpu", "meta", "cpu", "meta", "cpu", "meta"]
    mesh = pm.make_mesh((2, 3), ("batch", "y"), devices=devs)
    cpu, meta = torch.device("cpu"), torch.device("meta")
    assert mesh.axis_devices("y") == (cpu, meta, cpu)
    assert mesh.devices_along("y", "batch", 1) == (meta, cpu, meta)
    assert mesh.axis_devices("batch") == (cpu, meta)
    assert mesh.devices_along("batch", "y", 2) == (cpu, meta)
    for bad in (("y", "batch", 2), ("y", "z", 0), ("y", "y", 0), ("z", "batch", 0)):
        with pytest.raises(ValueError):
            mesh.devices_along(*bad)
    with pytest.raises(ValueError):
        mesh.axis_devices("z")


B_PAIRS = 4


def _mesh_2d():
    return pm.make_mesh((2, 2), ("batch", "y"), devices=["cpu"] * 4)


@pytest.fixture(scope="module")
def batch_case(pair):
    """B = 4 pairs at H x W: two textures, a shifted copy, and an identical
    pair whose one point constraint sits on the corner pixel, where the
    boundary lock holds both components: a non-zero energy and a zero
    descent direction, so that pair stalls after n_colors + 1 iterations
    and the pairs stop at different counts. The reference solves them on
    ``jax_make_mesh((2, 2), ("batch", "y"))``."""
    i0, i1 = pair
    pairs = [(i0, i1), (i1, i0), (i0, np.roll(i0, 2, axis=1)), (i0, i0)]
    ui_w = np.zeros((B_PAIRS, H, W, 1), np.float32)
    ui_v = np.zeros((B_PAIRS, H, W, 2), np.float32)
    ui_w[3, 0, 0] = 1.0
    ui_v[3, 0, 0] = 10.0
    p_kw = dict(lambda_tps=0.01, backend="jnp")
    v0 = np.zeros((B_PAIRS, H, W, 2), np.float32)
    jdata = [jax_level_data(jnp.asarray(a), jnp.asarray(b), jnp.asarray(w), jnp.asarray(u))
             for (a, b), w, u in zip(pairs, ui_w, ui_v)]
    jdata = type(jdata[0])(*(jnp.stack(f) for f in zip(*jdata)))
    solve = jax_spatial_solver(JaxMorphParams(**p_kw), 6, jax_make_mesh((2, 2), ("batch", "y")),
                               axis="y", batch_axis="batch")
    v_ref, st_ref = solve(jnp.asarray(v0), jdata)
    data = [level_data_from_numpy(a, b, w, u) for (a, b), w, u in zip(pairs, ui_w, ui_v)]
    p = MorphParams(**p_kw)
    v, st = make_spatial_level_solver(p, 6, _mesh_2d(), batch_axis="batch")(
        torch.from_numpy(v0), LevelData(*(torch.stack(f) for f in zip(*data))))
    return dict(ref=(np.asarray(v_ref), st_ref), got=(v, st), data=data, p=p)


def test_batch_axis_solver_output_shapes(batch_case):
    v, st = batch_case["got"]
    assert tuple(v.shape) == (B_PAIRS, H, W, 2)
    assert tuple(st.energy_history.shape) == (B_PAIRS, 6)
    for f in ("e0", "e_final", "iters", "step"):
        assert tuple(getattr(st, f).shape) == (B_PAIRS,), f
    iters = st.iters.tolist()
    assert iters == np.asarray(batch_case["ref"][1].iters).tolist()
    assert len(set(iters)) > 1 and iters[3] == MorphParams().n_colors + 1, iters


@pytest.mark.parametrize("i", range(B_PAIRS))
def test_batch_axis_solver_matches_reference(batch_case, i):
    """Each pair within ``_check_level``'s tolerances of the reference's
    vmapped ``shard_map`` on its (2, 2) mesh (v within 2e-3, e0 within 1e-5
    relative, e_final within 1e-4 relative)."""
    v_ref, st_ref = batch_case["ref"]
    v, st = batch_case["got"]
    ref_i = type(st_ref)(*(np.asarray(f)[i] for f in st_ref))
    assert int(st.iters[i]) == int(ref_i.iters)
    _check_level(v_ref[i], ref_i, v[i], type(st)(*(f[i] for f in st)))


@pytest.mark.parametrize("i", range(B_PAIRS))
def test_batch_axis_solver_is_the_1d_solver_per_pair(batch_case, i):
    """Pair i bitwise equal to the 1-D solver on a (2,) mesh for it alone."""
    v, st = batch_case["got"]
    v1, st1 = make_spatial_level_solver(batch_case["p"], 6, pm.make_mesh((2,), ("y",), devices=["cpu"] * 2))(
        torch.zeros((H, W, 2)), batch_case["data"][i])
    assert torch.equal(v[i], v1)
    assert int(st.iters[i]) == st1.iters
    for f in ("e0", "e_final", "step"):
        assert float(getattr(st, f)[i]) == getattr(st1, f), f
    assert torch.equal(st.energy_history[i].isnan(), st1.energy_history.isnan())
    assert torch.equal(st.energy_history[i].nan_to_num(), st1.energy_history.nan_to_num())


def test_batch_axis_solver_checks_its_batch(pair):
    i0, i1 = pair
    data = level_data_from_numpy(i0, i1)
    three = LevelData(*(torch.stack([f] * 3) for f in data))
    solve = make_spatial_level_solver(MorphParams(), 2, _mesh_2d(), batch_axis="batch")
    with pytest.raises(ValueError, match="does not divide"):
        solve(torch.zeros((3, H, W, 2)), three)
    with pytest.raises(ValueError, match="batch_axis"):
        make_spatial_level_solver(MorphParams(), 2, _mesh_2d(), batch_axis="y")


def test_1d_entry_point_on_a_2d_mesh():
    """``render_video_frames_sharded`` over "batch" of a (2, 2) mesh equals
    the same call on the (2,) mesh: the "y" axis holds replicas."""
    from videomorphing_tpu_torch.parallel.frames import render_video_frames_sharded

    rng = np.random.default_rng(4)
    clip_a = torch.from_numpy(rng.random((4, 16, 20, 3), dtype=np.float32))
    clip_b = torch.from_numpy(rng.random((4, 16, 20, 3), dtype=np.float32))
    fields = torch.from_numpy((0.5 * rng.standard_normal((4, 16, 20, 2))).astype(np.float32))
    times = np.linspace(0.0, 1.0, 4, dtype=np.float32)
    flat = pm.make_mesh((2,), ("batch",), devices=["cpu"] * 2)
    b1, f1 = render_video_frames_sharded(clip_a, clip_b, fields, times, flat)
    b2, f2 = render_video_frames_sharded(clip_a, clip_b, fields, times, _mesh_2d())
    assert torch.equal(f1, f2) and torch.equal(b1, b2)


def test_optimize_pair_spatial_matches_reference(pair, jmesh):
    i0 = pair[0]
    i1 = np.roll(i0, 2, axis=1)
    kw_ = dict(n_levels=2, iters_coarse=20, iters_fine=10, backend="jnp")
    ref = jax_optimize_pair_spatial(jnp.asarray(i0), jnp.asarray(i1), params=JaxMorphParams(**kw_), mesh=jmesh)
    res = optimize_pair_spatial(i0, i1, params=MorphParams(**kw_), mesh=_cpu_mesh())
    assert tuple(res.v.shape) == (H, W, 2) and res.v.device.type == "cpu"
    assert [level_is_sharded(lh, N_DEV, MorphParams()) for lh in (32, 64)] == [True, True]
    err = np.abs(res.v.numpy() - np.asarray(ref.v))
    assert np.percentile(err, 99) < 5e-3, np.percentile(err, 99)
    assert err.max() < 0.05, err.max()
    assert [s.iters for s in res.level_stats] == [int(s.iters) for s in ref.level_stats]


@pytest.mark.parametrize("window", [9, 11])
def test_spatial_solve_matches_reference_at_wide_windows(jmesh, window):
    """Windows past 7 (sigma 1.5) on the bench's 64 x 48 frame and its copy
    rolled by 2 columns: the shard forms' reach follows the window (2R
    rows, exchange halo 2R + 2), so the row-sharded fine level solves as
    the reference's does; tolerances as at the default window."""
    import bench

    clip_a, _ = bench._make_clips(1, H, W, seed=0)
    i0 = np.asarray(clip_a[0])
    i1 = np.roll(i0, 2, axis=1)
    kw_ = dict(n_levels=2, iters_coarse=20, iters_fine=10, backend="jnp", ssim_window=window, ssim_sigma=1.5)
    ref = jax_optimize_pair_spatial(jnp.asarray(i0), jnp.asarray(i1), params=JaxMorphParams(**kw_), mesh=jmesh)
    p = MorphParams(**kw_)
    res = optimize_pair_spatial(i0, i1, params=p, mesh=_cpu_mesh())
    assert ks.shard_reach(p) == window - 1 and exchange_halo(p) == window + 1
    assert level_is_sharded(H, N_DEV, p)
    err = np.abs(res.v.numpy() - np.asarray(ref.v))
    assert np.percentile(err, 99) < 5e-3, np.percentile(err, 99)
    assert err.max() < 0.05, err.max()
    assert [s.iters for s in res.level_stats] == [int(s.iters) for s in ref.level_stats]


def test_optimize_pair_spatial_solves_undividing_levels_locally():
    rng = np.random.default_rng(1)
    h = 72  # levels 72, 36, 18: the last does not divide over 4 blocks
    i0 = _smooth(rng, h, 32)
    i1 = np.roll(i0, 1, axis=1)
    assert [level_is_sharded(lh, N_DEV, MorphParams()) for lh in (18, 36, 72)] == [False, True, True]
    res = optimize_pair_spatial(i0, i1, params=MorphParams(n_levels=3, iters_coarse=10, iters_fine=5),
                                mesh=_cpu_mesh())
    assert tuple(res.v.shape) == (h, 32, 2) and torch.isfinite(res.v).all()
    assert len(res.level_stats) == 3


# ------------------------------------------- the card is the default device


@pytest.mark.parametrize("entry", [
    "morph_pair", "solve_pair", "morph_clips", "morph_pair_layered", "morph_clips_layered",
    "Session", "ImageMorpher", "VideoMorpher", "optimize_pair_spatial",
])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """Without ``device=`` every entry point runs on the card: with no card
    a numpy call raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((16, 16, 3), np.float32)
    clip = np.zeros((2, 16, 16, 3), np.float32)
    timg = torch.from_numpy(img)
    layer = dict(mask0=np.ones((16, 16), np.float32), mask1=np.ones((16, 16), np.float32))
    call = {
        "morph_pair": lambda: api.morph_pair(img, img),
        "solve_pair": lambda: api.solve_pair(img, img),
        "morph_clips": lambda: api.morph_clips(clip, clip),
        "morph_pair_layered": lambda: api.morph_pair_layered(img, img, [layer]),
        "morph_clips_layered": lambda: api.morph_clips_layered(clip, clip, [layer]),
        "Session": lambda: api.Session(img, img),
        "ImageMorpher": lambda: ImageMorpher().solve(timg, timg),
        "VideoMorpher": lambda: VideoMorpher()(torch.from_numpy(clip), torch.from_numpy(clip)),
        "optimize_pair_spatial": lambda: optimize_pair_spatial(img, img),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
