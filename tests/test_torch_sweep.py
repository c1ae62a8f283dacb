"""Port parity: the plain versions of sweep kernels 1 and 2.

Kernel 1's plain version (``linearized_warps`` + ``value_grad_precond_planes``
behind ``kernels.sweep.sweep_grad``) and kernel 2's (``total_energy_planes``
behind ``sweep_energy``) against the JAX reference's oracles, on warps
linearized around ``v_lin != v`` with non-zero UI and TC maps.
Tolerances: energy relative error <= 1e-5; grad and precond max abs
<= 1e-5 * max|ref|. The windows run from 1 to 17 (the kernels'
instantiated radii, 0-7, and the wide strip's first, 8); the row-shard
forms sum to the
reference's whole-frame energy and, on their owned rows, give its
gradient. The CUDA kernels themselves are held to these plain versions on
the card by ``chip_smoke.py``; here also the tiles that size their
partials, the even-window rule and the symmetric taps the energy strip
relies on.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videomorphing_tpu.config import MorphParams as JaxMorphParams
from videomorphing_tpu.solver import descent as jd
from videomorphing_tpu.solver.energy import make_level_data
from videomorphing_tpu_torch.config import MorphParams
from videomorphing_tpu_torch.interop import level_data_from_numpy
from videomorphing_tpu_torch.kernels import sweep as ks
from videomorphing_tpu_torch.kernels import warp as kw

torch.set_num_threads(2)


def _case(h, w, seed, c=3):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    v_lin = np.stack([2.0 * np.sin(yy / 9.0), 1.5 * np.cos(xx / 11.0)], -1).astype(np.float32)
    v = (v_lin + 0.3 * rng.standard_normal((h, w, 2))).astype(np.float32)
    # constraint targets near v, so the four energy terms are of one order
    # and the energy comparison sees the SSIM term too
    arrs = dict(
        i0=rng.random((h, w, c), dtype=np.float32),
        i1=rng.random((h, w, c), dtype=np.float32),
        ui_w=rng.random((h, w, 1), dtype=np.float32),
        ui_v=(v + 0.1 * rng.standard_normal((h, w, 2))).astype(np.float32),
        tc_w=rng.random((h, w, 1), dtype=np.float32),
        tc_v=(v + 0.5 * rng.standard_normal((h, w, 2))).astype(np.float32),
    )
    return arrs, v_lin, v


def _reference(arrs, v_lin, v, p):
    data = make_level_data(*(jnp.asarray(arrs[k]) for k in ("i0", "i1", "ui_w", "ui_v", "tc_w", "tc_v")))
    wb = jd.warp_bundle(jnp.asarray(v_lin), data)
    w0e, w1e = jd.linearized_warps(wb, jnp.asarray(v))
    e, g, pc = jd.value_grad_precond_planes(w0e, wb.dw0, w1e, wb.dw1, jnp.asarray(v), data, p)
    et = jd.total_energy_planes(w0e, w1e, jnp.asarray(v), data, p)
    return float(e), np.asarray(g), np.asarray(pc), float(et)


def _port(arrs, v_lin, v, p, device="cpu"):
    data = level_data_from_numpy(**arrs, device=device)
    t = lambda x: torch.from_numpy(x).to(device)
    planes = kw.halfway_warp(data.i0, data.i1, t(v_lin))
    e, g, pc = ks.sweep_grad(planes, t(v_lin), t(v), data, p)
    et = ks.sweep_energy(planes, t(v_lin), t(v), data, p)
    return float(e), g.cpu().numpy(), pc.cpu().numpy(), float(et)


def _assert_close(ref, got):
    e_r, g_r, p_r, et_r = ref
    e_g, g_g, p_g, et_g = got
    assert abs(e_g - e_r) <= 1e-5 * abs(e_r)
    assert abs(et_g - et_r) <= 1e-5 * abs(et_r)
    assert g_g.shape == g_r.shape and p_g.shape == p_r.shape
    assert np.max(np.abs(g_g - g_r)) <= 1e-5 * np.max(np.abs(g_r))
    assert np.max(np.abs(p_g - p_r)) <= 1e-5 * np.max(np.abs(p_r))


PARAMS = [
    JaxMorphParams(),
    JaxMorphParams(ssim_use_luminance=False, lambda_tps=0.05, gamma_ui=5.0),
    JaxMorphParams(ssim_window=7, ssim_sigma=1.5),
    JaxMorphParams(ssim_window=9, ssim_sigma=1.5),
    JaxMorphParams(ssim_window=11, ssim_sigma=1.5),
    JaxMorphParams(ssim_window=15, ssim_sigma=2.5),
    JaxMorphParams(ssim_window=1, ssim_sigma=1.0),
    JaxMorphParams(ssim_window=17, ssim_sigma=3.0),
]


@pytest.mark.parametrize("hw", [(37, 53), (64, 300)])
@pytest.mark.parametrize("pi", range(len(PARAMS)))
def test_sweep_plain_matches_reference(hw, pi):
    jp = PARAMS[pi]
    p = MorphParams(**dataclasses.asdict(jp))
    arrs, v_lin, v = _case(*hw, seed=pi)
    _assert_close(_reference(arrs, v_lin, v, jp), _port(arrs, v_lin, v, p))
    assert ks.sweep_grad.launches == 0 and ks.sweep_energy.launches == 0


def test_sweep_exact_at_linearization_point():
    """At v == v_lin the linearized energy is the exact energy."""
    from videomorphing_tpu_torch.solver.energy import total_energy

    arrs, v_lin, _ = _case(30, 41, seed=9)
    data = level_data_from_numpy(**arrs)
    v = torch.from_numpy(v_lin)
    planes = kw.halfway_warp(data.i0, data.i1, v)
    e = float(ks.sweep_energy(planes, v, v, data, MorphParams()))
    assert abs(e - float(total_energy(v, data, MorphParams()))) <= 1e-6 * abs(e)


@pytest.mark.parametrize("with_grad", [True, False], ids=["grad", "energy"])
def test_sweep_tile_comes_from_the_source(with_grad):
    """The tile that sizes a kernel's partials is the one ``csrc/sweep.cu``
    sets for it: ``TILE_*`` for the gradient kernel, ``ENERGY_TILE_*`` for
    the energy kernel."""
    import re

    from videomorphing_tpu_torch.kernels import build

    prefix = "" if with_grad else "ENERGY_"
    rows, cols = ks.sweep_tile(with_grad)
    text = (build.CSRC_DIR / "sweep.cu").read_text()
    assert f"constexpr int {prefix}TILE_ROWS = {rows};" in text
    assert f"constexpr int {prefix}TILE_COLS = {cols};" in text
    assert rows > 0 and cols > 0
    assert not re.search(r"\bTILE\s*=\s*16\b", (build.PACKAGE_DIR / "kernels" / "sweep.py").read_text())


def _blocks_by_origin(w, nown, with_grad, radius=1):
    """Blocks of a launch, counted from the tile origins of the owned rows."""
    rows, cols = ks.sweep_tile(with_grad, radius)
    return len({(y // rows, x // cols) for y in range(nown) for x in range(w)})


@pytest.mark.parametrize("with_grad", [True, False], ids=["grad", "energy"])
@pytest.mark.parametrize(
    "w,nown",
    [(1024, 1024), (241, 135), (1, 1), (30, 17), (33, 16), (3840, 540), (241, 33), (1920, 1080), (37, 53)],
    ids=["1k", "ragged", "one-pixel", "4k-level-width-30", "one-column-over", "4k-row-block",
         "ragged-row-block", "1080p", "37x53"],
)
def test_n_partials_covers_every_tile(w, nown, with_grad):
    """The partials buffer holds one set per block: ragged shapes and the
    row-shard geometry (a block's owned rows only) round up per axis."""
    assert ks.n_partials(w, nown, with_grad) == _blocks_by_origin(w, nown, with_grad)


@pytest.mark.parametrize("window", [5, 9])
def test_shard_energies_sum_to_the_reference_total_energy(window):
    """Kernel 2's row-shard form (plain version): the raw partials of 4 row
    blocks, summed in block order and combined, give the reference's
    linearized total energy of the whole frame (``total_energy_planes``)
    and the whole-frame form's energy, within 1e-5 relative; at the default
    window and at window 9 (reach 8 rows)."""
    from videomorphing_tpu_torch.interop import level_data_from_numpy
    from videomorphing_tpu_torch.solver.energy import LevelData

    h, w, n = 40, 56, 4
    p = MorphParams() if window == 5 else MorphParams(ssim_window=window, ssim_sigma=1.5)
    arrs, v_lin, v = _case(h, w, seed=12)
    ref = _reference(arrs, v_lin, v, JaxMorphParams(**dataclasses.asdict(p)))[3]
    data = level_data_from_numpy(**arrs)
    halo = ks.shard_reach(p)
    bh = h // n
    pad = lambda a: np.pad(a, ((halo, halo), (0, 0), (0, 0)))
    acc = np.zeros(4, np.float32)
    for k in range(n):
        row0 = k * bh - halo
        ext = lambda a: torch.from_numpy(pad(a)[k * bh:k * bh + bh + 2 * halo].copy())
        vl_e, v_e = ext(v_lin), ext(v)
        planes = kw.halfway_warp_rows(data.i0, data.i1, vl_e, row0)
        blk = LevelData(data.i0, data.i1, *(m[k * bh:(k + 1) * bh] for m in (data.ui_w, data.ui_v, data.tc_w, data.tc_v)))
        acc = acc + ks.sweep_energy_shard(planes, vl_e, v_e, blk, p, row0, h, halo).numpy()
    e_shard = float(ks.combine_parts(acc, p, h * w, 3))
    planes = kw.halfway_warp(data.i0, data.i1, torch.from_numpy(v_lin))
    e_whole = float(ks.sweep_energy(planes, torch.from_numpy(v_lin), torch.from_numpy(v), data, p))
    assert abs(e_shard - ref) <= 1e-5 * abs(ref)
    assert abs(e_shard - e_whole) <= 1e-5 * abs(e_whole)
    assert ks.sweep_energy_shard.launches == 0


def test_shard_grads_cover_the_reference_gradient():
    """Kernel 1's row-shard form (plain version) at window 9: the owned
    rows' grad and precond of 4 row blocks, stacked in block order, and
    their raw partials, summed and combined, against the reference's
    whole-frame ``energy_value_grad_precond`` (1e-5 of max|ref|, energy
    1e-5 relative)."""
    from videomorphing_tpu_torch.solver.energy import LevelData

    h, w, n = 40, 56, 4
    p = MorphParams(ssim_window=9, ssim_sigma=1.5)
    arrs, v, _ = _case(h, w, seed=13)
    jdata = make_level_data(*(jnp.asarray(arrs[k]) for k in ("i0", "i1", "ui_w", "ui_v", "tc_w", "tc_v")))
    e_r, g_r, p_r = jd.energy_value_grad_precond(jnp.asarray(v), jdata, JaxMorphParams(**dataclasses.asdict(p)))
    g_r, p_r = np.asarray(g_r), np.asarray(p_r)
    data = level_data_from_numpy(**arrs)
    halo = ks.shard_reach(p)
    assert halo == 8
    bh = h // n
    pad = lambda a: np.pad(a, ((halo, halo), (0, 0), (0, 0)))
    acc = np.zeros(4, np.float32)
    grads, preconds = [], []
    for k in range(n):
        row0 = k * bh - halo
        v_e = torch.from_numpy(pad(v)[k * bh:k * bh + bh + 2 * halo].copy())
        planes = kw.halfway_warp_rows(data.i0, data.i1, v_e, row0)
        blk = LevelData(data.i0, data.i1, *(m[k * bh:(k + 1) * bh] for m in (data.ui_w, data.ui_v, data.tc_w, data.tc_v)))
        parts, g, pc = ks.sweep_grad_shard(planes, v_e, v_e, blk, p, row0, h, halo)
        acc = acc + parts.numpy()
        grads.append(g.numpy())
        preconds.append(pc.numpy())
    g, pc = np.concatenate(grads), np.concatenate(preconds)
    assert g.shape == g_r.shape == (h, w, 2) and pc.shape == p_r.shape
    assert np.max(np.abs(g - g_r)) <= 1e-5 * np.max(np.abs(g_r))
    assert np.max(np.abs(pc - p_r)) <= 1e-5 * np.max(np.abs(p_r))
    e = float(ks.combine_parts(acc, p, h * w, 3))
    assert abs(e - float(e_r)) <= 1e-5 * abs(float(e_r))
    assert ks.sweep_grad_shard.launches == 0


def test_scalars_hold_every_tap_of_a_wide_window():
    """At window 15 the kernels' constants point at the window's 15 taps
    (the reference's ``gaussian_kernel_1d``), with radius 7; a buffer of
    another length is refused."""
    from videomorphing_tpu.ops.windows import gaussian_kernel_1d

    p = MorphParams(ssim_window=15, ssim_sigma=2.5)
    taps = ks.window_taps(p, "cpu")
    assert taps.dtype == torch.float32 and taps.shape == (15,)
    np.testing.assert_array_equal(taps.numpy(), np.asarray(gaussian_kernel_1d(15, 2.5), np.float32))
    assert ks.window_taps(p, "cpu") is taps
    s = ks._scalars(p, 40, 56, 3, taps=taps)
    assert s.radius == 7 and s.taps == taps.data_ptr()
    with pytest.raises(ValueError, match="taps for a window of radius 7"):
        ks._scalars(p, 40, 56, 3, taps=ks.window_taps(MorphParams(ssim_window=13), "cpu"))


@pytest.mark.parametrize("with_grad", [True, False], ids=["grad", "energy"])
@pytest.mark.parametrize("radius", [4, 7])
def test_n_partials_covers_every_tile_at_wide_radii(radius, with_grad):
    """Past radius 2 the gradient kernel walks strips of 72 x 64 pixels (R
    = 4 and 7), and past radius 3 the energy kernel's blocks are 16 rows of
    4 warps side by side, each owning 32 - 2R columns (4 x 24 at R = 4, 4 x
    18 at R = 7); the partials buffer holds one set per block of each."""
    geometry = {(4, True): (72, 64), (4, False): (16, 96), (7, True): (72, 64), (7, False): (16, 72)}
    assert ks.tiled(with_grad, radius)
    assert ks.sweep_tile(with_grad, radius) == geometry[radius, with_grad]
    for w, nown in [(1024, 1024), (241, 135), (1, 1), (30, 17), (3840, 540), (37, 53)]:
        assert ks.n_partials(w, nown, with_grad, radius) == _blocks_by_origin(w, nown, with_grad, radius)


def _source_constant(name):
    import re

    from videomorphing_tpu_torch.kernels import build

    m = re.search(rf"^constexpr int {name} = (\d+);", (build.CSRC_DIR / "sweep.cu").read_text(), re.M)
    assert m, name
    return int(m.group(1))


def _by_radius(radius, lo, hi, tile, strip, with_grad):
    """The blocks and the kernel's kind at ``radius`` for a kernel whose
    tile takes R = 0 .. lo - 1 and its strip lo .. hi: past hi the wide
    strip up to ``WIDE_MAX_RADIUS``, then the per-pixel chain."""
    reach = _source_constant("WIDE_MAX_RADIUS")
    rows = _source_constant("WIDE_STRIP_ROWS" if with_grad else "WIDE_ENERGY_STRIP_ROWS")
    wide = (rows, _source_constant("WIDE_STRIP_COLS"))
    chain = (_source_constant("CHAIN_TILE_ROWS"), _source_constant("CHAIN_TILE_COLS"))
    if radius < lo:
        return tile, "tile"
    if radius <= hi:
        return strip, "strip"
    return (wide, "wide") if radius <= reach else (chain, "chain")


@pytest.mark.parametrize("radius", list(range(0, 10)) + [24, 25])
def test_gradient_kernel_by_radius_comes_from_the_source(radius):
    """The gradient kernel's blocks at each radius, from the constants of
    ``csrc/sweep.cu``: R = 0, 1, 2 keep the tile of ``TILE_ROWS`` x
    ``TILE_COLS`` (16 x 32); ``STRIP_MIN_RADIUS`` .. ``STRIP_MAX_RADIUS``
    (3 .. 7) run the strip kernel on ``STRIP_ROWS`` x ``STRIP_COLS``; R = 8
    .. ``WIDE_MAX_RADIUS`` (24) the wide strip on ``WIDE_STRIP_ROWS`` x
    ``WIDE_STRIP_COLS`` (128 x 32); the radii past it the per-pixel chain. The energy
    kernel keeps its own radii (0 .. ``ENERGY_STRIP_MAX_RADIUS``)."""
    lo, hi = _source_constant("STRIP_MIN_RADIUS"), _source_constant("STRIP_MAX_RADIUS")
    assert (lo, hi) == (3, 7) and _source_constant("ENERGY_STRIP_MAX_RADIUS") == 7
    assert _source_constant("WIDE_MAX_RADIUS") == 24
    tile = (_source_constant("TILE_ROWS"), _source_constant("TILE_COLS"))
    strip = (_source_constant("STRIP_ROWS"), _source_constant("STRIP_COLS"))
    assert tile == (16, 32)
    expect, kind = _by_radius(radius, lo, hi, tile, strip, True)
    assert kind != "wide" or expect == (128, 32)
    assert ks.sweep_tile(True, radius) == expect
    assert ks.tiled(True, radius) == (0 <= radius <= hi)
    assert ks.tiled(False, radius) == (0 <= radius <= 7)
    assert ks.wide_strip(True, radius) == (kind == "wide")
    name = ks.kernel_name(True, radius)
    assert name == {"tile": f"sweep_grad_kernel<{radius}>", "strip": f"sweep_grad_strip_kernel<{radius}>",
                    "wide": "sweep_wide_kernel (gradient)", "chain": "per-pixel chain (gradient)"}[kind]


STRIP_SHAPES = pytest.mark.parametrize(
    "w,nown",
    [(1024, 1024), (241, 135), (1, 1), (30, 17), (65, 72), (3840, 540), (241, 33), (1920, 1080), (37, 53),
     (3840, 572)],
    ids=["1k", "ragged", "one-pixel", "4k-level-width-30", "one-column-over", "4k-row-block",
         "ragged-row-block", "1080p", "37x53", "4k-row-block-window-15"],
)


@pytest.mark.parametrize("radius", [3, 5, 7])
@STRIP_SHAPES
def test_n_partials_covers_every_strip(w, nown, radius):
    """The strip kernel's partials: one set per strip of owned rows and
    columns, counted from the strips' origins, for whole frames and for a
    row shard's owned rows (the 4K row blocks)."""
    assert ks.n_partials(w, nown, True, radius) == _blocks_by_origin(w, nown, True, radius)


@pytest.mark.parametrize("radius", [4, 5, 7])
@STRIP_SHAPES
def test_n_partials_covers_every_energy_strip(w, nown, radius):
    """The energy strip's partials: one set per block of 16 owned rows and
    4 warps' owned columns, counted from the blocks' origins, for whole
    frames and for a row shard's owned rows."""
    assert ks.sweep_tile(False, radius) == (16, 4 * (32 - 2 * radius))
    assert ks.n_partials(w, nown, False, radius) == _blocks_by_origin(w, nown, False, radius)


@pytest.mark.parametrize("radius", list(range(0, 10)) + [24, 25])
def test_energy_kernel_by_radius_comes_from_the_source(radius):
    """The energy kernel's blocks at each radius, from the constants of
    ``csrc/sweep.cu``: R = 0 .. 3 keep the tile of ``ENERGY_TILE_ROWS`` x
    ``ENERGY_TILE_COLS`` (32 x 26); ``ENERGY_STRIP_MIN_RADIUS`` ..
    ``ENERGY_STRIP_MAX_RADIUS`` (4 .. 7) run the strip on blocks of
    ``ENERGY_STRIP_ROWS`` rows and ``ENERGY_STRIP_WARPS`` warps of 32 - 2R
    owned columns; R = 8 .. ``WIDE_MAX_RADIUS`` the wide strip on
    ``WIDE_ENERGY_STRIP_ROWS`` x ``WIDE_STRIP_COLS`` (64 x 32) and the
    radii past it the per-pixel chain."""
    lo, hi = _source_constant("ENERGY_STRIP_MIN_RADIUS"), _source_constant("ENERGY_STRIP_MAX_RADIUS")
    assert (lo, hi) == (4, 7)
    tile = (_source_constant("ENERGY_TILE_ROWS"), _source_constant("ENERGY_TILE_COLS"))
    strip = (_source_constant("ENERGY_STRIP_ROWS"), _source_constant("ENERGY_STRIP_WARPS") * (32 - 2 * radius))
    assert tile == (32, 26) and strip[0] == 16
    expect, kind = _by_radius(radius, lo, hi, tile, strip, False)
    assert kind != "wide" or expect == (64, 32)
    assert ks.sweep_tile(False, radius) == expect
    assert ks.tiled(False, radius) == (0 <= radius <= hi)
    assert ks.wide_strip(False, radius) == (kind == "wide")
    assert ks.kernel_name(False, radius) == {
        "tile": f"sweep_energy_kernel<{radius}>", "strip": f"sweep_energy_strip_kernel<{radius}>",
        "wide": "sweep_wide_kernel (energy)", "chain": "per-pixel chain (energy)"}[kind]


@pytest.mark.parametrize("with_grad", [True, False], ids=["grad", "energy"])
@pytest.mark.parametrize("radius", [0, 8, 16, 24, 25])
@STRIP_SHAPES
def test_n_partials_covers_the_wide_windows(w, nown, radius, with_grad):
    """The partials of the wide windows' kernels: the tiles at R = 0
    (window 1), the wide strip's blocks of 128 x 32 owned pixels (the
    energy form's 64 x 32) at R = 8, 16 and 24 (windows 17, 33 and 49, its
    reach), the per-pixel chain's 8 x 32 at R = 25; one set per block,
    counted from the blocks' origins on each axis, for whole frames and a
    row shard's owned rows."""
    rows, cols = ks.sweep_tile(with_grad, radius)
    strip = (128, 32) if with_grad else (64, 32)
    expect = {0: (16, 32) if with_grad else (32, 26), 8: strip, 16: strip, 24: strip, 25: (8, 32)}
    assert (rows, cols) == expect[radius]
    n_rows = len({y // rows for y in range(nown)})
    n_cols = len({x // cols for x in range(w)})
    assert ks.n_partials(w, nown, with_grad, radius) == n_rows * n_cols


@pytest.mark.parametrize("window", [3, 5, 9, 11, 15, 17, 31])
def test_window_taps_are_symmetric_as_the_reference_s(window):
    """The energy strip keeps R + 1 taps for the K = 2R + 1 of a window, so
    every product and sum keeps its value only if ``taps[t] ==
    taps[K - 1 - t]`` exactly: so it is for the reference's taps
    (``gaussian_kernel_1d``) and the port's at every sigma phase 2 runs."""
    from videomorphing_tpu.ops.windows import gaussian_kernel_1d

    for sigma in (1.0, 1.5, 2.0, 2.5, 3.0):
        ref = np.asarray(gaussian_kernel_1d(window, sigma), np.float32)
        np.testing.assert_array_equal(ref, ref[::-1])
        taps = ks.window_taps(MorphParams(ssim_window=window, ssim_sigma=sigma), "cpu").numpy()
        np.testing.assert_array_equal(taps, ref)


def test_window_taps_refuses_asymmetric_taps(monkeypatch):
    """``window_taps`` raises ``ValueError`` on taps that are not symmetric
    rather than hand the energy strip a buffer whose mirrored half it would
    misread."""
    monkeypatch.setattr(ks, "gaussian_taps", lambda k, sigma: (0.25, 0.5, 0.2500001))
    with pytest.raises(ValueError, match="not symmetric"):
        ks.window_taps(MorphParams(ssim_window=3, ssim_sigma=0.731), "cpu")


def test_even_windows_are_refused_by_the_kernels():
    """An even window's taps are not centred on the pixel, so the kernels
    refuse it (``kernel_radius`` raises ``ValueError`` before any launch)
    rather than compute another function than their plain version; the
    reference and the plain version fail on it too (their window sums do
    not keep the image's shape). Every odd window has a radius, past the
    tiled ones too."""
    assert [ks.kernel_radius(MorphParams(ssim_window=k)) for k in (1, 3, 9, 13, 15, 31)] == [0, 1, 4, 6, 7, 15]
    for k in (2, 4, 8):
        with pytest.raises(ValueError, match="odd ssim_window"):
            ks.kernel_radius(MorphParams(ssim_window=k))
        with pytest.raises(ValueError, match="odd ssim_window"):
            ks._scalars(MorphParams(ssim_window=k), 24, 30, 3)
    jp = JaxMorphParams(ssim_window=4)
    arrs, v_lin, v = _case(24, 30, seed=14)
    with pytest.raises(TypeError):
        _reference(arrs, v_lin, v, jp)
    with pytest.raises(RuntimeError):
        _port(arrs, v_lin, v, MorphParams(**dataclasses.asdict(jp)))
