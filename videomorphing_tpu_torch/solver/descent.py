"""Per-level descent: multi-colour preconditioned updates with line search.

Port of ``videomorphing_tpu/solver/descent.py``. Each iteration masks the
preconditioned descent direction to one checkerboard colour and the
boundary lock, clamps it against foldover, and runs one Armijo
backtracking on the total energy. The warps are re-evaluated every
``relin_every`` iterations (kernel 3, ``halfway_warp``); in between, the
sweep kernels (1 and 2) work on the first-order expansion around that
linearization point.

Backend: the kernels run whenever the tensors lie on the card and their
plain versions run on the CPU (``kernels/``); both compute the same
numbers, and on the card no plain version may run on the main path.
``backend`` and ``pallas_min_pixels`` are read for one choice only, the
dtype of the sweeps' static pack (:func:`pack_dtype_for`, the reference's
``_resolve_backend``): ``pack_dtype="bfloat16"`` takes effect where the
reference's Pallas path would run, with ``backend="pallas"`` on any
device and with ``"auto"`` on the card on levels of at least
``pallas_min_pixels`` pixels; elsewhere the pack is float32, as the
reference's jnp path is. ``fused_warp``, ``warp_into_pack`` and
``warp_prescreen`` are exact TPU options and are ignored.

The level loop runs in Python and keeps v, the warp planes and the step
direction on the device; it reads back only the scalars the loop
conditions and the Armijo test need, once an iteration and once a
backtrack, and does that scalar arithmetic in float32 as the reference's
``lax.while_loop`` does. Between two reads the card runs a fixed chain of
about sixty launches on fixed shapes, which the host takes longer to issue
than the card to run, so on the card each such chain is a replay of a CUDA
graph captured once per level signature (:func:`level_graph_key`), as the
render's frames are (``synth/render.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from videomorphing_tpu_torch.config import MorphParams
from videomorphing_tpu_torch.graphs import LRU, Captured, capture, replayable
from videomorphing_tpu_torch.kernels import COUNTED
from videomorphing_tpu_torch.kernels.sweep import pack_dtype, pack_maps, quantize_v_lin, strip, sweep_energy, sweep_grad
from videomorphing_tpu_torch.kernels.warp import bundle_from_planes, halfway_warp
from videomorphing_tpu_torch.ops.ssim import dssim_grad_bundle, dssim_map
from videomorphing_tpu_torch.ops.windows import gaussian_taps, median3x3, separable_filter
from videomorphing_tpu_torch.solver.energy import LevelData, quadratic_energies, tps_maps
from videomorphing_tpu_torch.utils import profiling

f32 = np.float32


class LevelStats(NamedTuple):
    """Per-level record: energies and step as float32 values, the iteration
    count, and the nan-padded energy after each iteration (CPU tensor)."""

    e0: float
    e_final: float
    iters: int
    step: float
    energy_history: torch.Tensor


def boundary_mask(h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(H, W, 2) mask locking v_y on the top/bottom rows and v_x on the
    left/right columns (edges map to edges)."""
    m = torch.ones((h, w, 2), dtype=dtype, device=device)
    m[0, :, 0] = 0.0
    m[-1, :, 0] = 0.0
    m[:, 0, 1] = 0.0
    m[:, -1, 1] = 0.0
    return m


def color_mask(h: int, w: int, color: int, n_colors: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(H, W, 1) checkerboard mask of one colour."""
    if n_colors == 1:
        return torch.ones((h, w, 1), dtype=dtype, device=device)
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    if n_colors == 2:
        idx = (ys + xs) % 2
    elif n_colors == 4:
        idx = (ys % 2) * 2 + (xs % 2)
    else:
        raise ValueError("n_colors must be 1, 2 or 4")
    return (idx == color).to(dtype)[..., None]


def _axis_gaps(comp: torch.Tensor, axis: int) -> torch.Tensor:
    fwd = torch.diff(comp, dim=axis)
    zero = torch.zeros_like(comp.narrow(axis, 0, 1))
    d_r = torch.cat([fwd, zero], dim=axis)
    d_l = torch.cat([zero, fwd], dim=axis)
    g = torch.minimum(torch.minimum(1.0 + d_r, 1.0 - d_r), torch.minimum(1.0 + d_l, 1.0 - d_l))
    return torch.clamp(g, min=0.0)


def foldover_scale(v: torch.Tensor, d: torch.Tensor, margin: float) -> torch.Tensor:
    """Clamp a step ``d`` so ``v + d`` folds neither warp: each pixel covers
    at most ``margin`` (< 1/2) of its smallest neighbour gap per axis.

    ``v`` may have as many more rows above as below ``d``'s (a row block's
    field extended by its neighbours' rows): the gaps are taken on all of
    ``v`` and clamp ``d`` at its own rows."""
    r = (v.shape[0] - d.shape[0]) // 2
    m_y = _axis_gaps(v[..., 0], 0)[r:r + d.shape[0]]
    m_x = _axis_gaps(v[..., 1], 1)[r:r + d.shape[0]]
    s_y = torch.clamp(margin * m_y / (torch.abs(d[..., 0]) + 1e-12), max=1.0)
    s_x = torch.clamp(margin * m_x / (torch.abs(d[..., 1]) + 1e-12), max=1.0)
    return torch.stack([d[..., 0] * s_y, d[..., 1] * s_x], dim=-1)


class WarpBundle(NamedTuple):
    """Warp linearization point: warped images and interpolant derivatives."""

    v_lin: torch.Tensor  # (H, W, 2)
    w0: torch.Tensor     # (H, W, C) I0(p - v_lin)
    dw0: torch.Tensor    # (H, W, C, 2)
    w1: torch.Tensor     # (H, W, C) I1(p + v_lin)
    dw1: torch.Tensor    # (H, W, C, 2)


def warp_bundle(v: torch.Tensor, data: LevelData) -> WarpBundle:
    """Re-warp both images at ``v``: kernel 3 (``halfway_warp``) on the
    card, its plain version (``bilinear_sample_with_grad`` at g -/+ v) on
    the CPU. The bundle's fields are views of kernel 3's (6C, H, W) plane
    stack; the level solver keeps that stack, which the sweeps read."""
    return WarpBundle(v, *bundle_from_planes(halfway_warp(data.i0, data.i1, v)))


def warp_bundle_fused(v: torch.Tensor, src0: torch.Tensor, src1: torch.Tensor,
                      prescreen: bool = False) -> WarpBundle:
    """The reference's name for :func:`warp_bundle` on the two (H, W, C)
    images: kernel 3 is the fused warp on the card, so there is no other
    path to fall back to; ``prescreen`` (exact in the reference) is
    ignored."""
    return WarpBundle(v, *bundle_from_planes(halfway_warp(src0, src1, v)))


def linearized_warps(wb: WarpBundle, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """First-order warped images at ``v`` around ``wb.v_lin`` (exact at v_lin)."""
    dv = v - wb.v_lin
    dvy, dvx = dv[..., 0:1], dv[..., 1:2]
    w0 = wb.w0 - (wb.dw0[..., 0] * dvy + wb.dw0[..., 1] * dvx)
    w1 = wb.w1 + (wb.dw1[..., 0] * dvy + wb.dw1[..., 1] * dvx)
    return w0, w1


def total_energy_planes(w0, w1, v: torch.Tensor, data: LevelData, p: MorphParams, *,
                        inv_n_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Total energy from (possibly linearized) warp planes: the plain
    version of the sweep energy kernel (``inv_n_dtype``: see
    ``ops.ssim``)."""
    e_sim = torch.mean(
        dssim_map(
            w0, w1, window=p.ssim_window, sigma=p.ssim_sigma,
            c1=p.ssim_c1, c2=p.ssim_c2, use_luminance=p.ssim_use_luminance, inv_n_dtype=inv_n_dtype,
        )
    )
    e_tps, e_ui, e_tc = quadratic_energies(v, data, p)
    return e_sim + e_tps + e_ui + e_tc


def value_grad_precond_planes(w0, dw0, w1, dw1, v: torch.Tensor, data: LevelData, p: MorphParams, *,
                              inv_n_dtype: torch.dtype = torch.float32):
    """(E, dE/dv, preconditioner) from warp planes: the plain version of the
    sweep gradient kernel (``inv_n_dtype``: see ``ops.ssim``).

    dE/dv chains the analytic SSIM image gradients through the interpolant
    derivatives (-dw0 for I0(p - v), +dw1 for I1(p + v)) and adds the TPS
    adjoint and the quadratic terms. The preconditioner is the Gauss-Newton
    diagonal: window-summed |dw|^2 / b2, plus the exact diagonals of the
    TPS, UI and TC quadratic forms, plus eps / N.
    """
    h, w, c = data.i0.shape
    npix = h * w
    bundle = dssim_grad_bundle(
        w0, w1, window=p.ssim_window, sigma=p.ssim_sigma,
        c1=p.ssim_c1, c2=p.ssim_c2, use_luminance=p.ssim_use_luminance, inv_n_dtype=inv_n_dtype,
    )
    g_sim = -(bundle.g0[..., None] * dw0).sum(2) + (bundle.g1[..., None] * dw1).sum(2)
    lam_n = p.lambda_tps / npix
    g_tps = lam_n * _tps_grad_unnormalized(v)
    g_ui = (2.0 * p.gamma_ui / npix) * data.ui_w * (v - data.ui_v)
    g_tc = (2.0 * p.beta_tc / npix) * data.tc_w * (v - data.tc_v)
    grad = g_sim + g_tps + g_ui + g_tc

    k = gaussian_taps(int(p.ssim_window), float(p.ssim_sigma))
    inv_b2 = 1.0 / bundle.b2
    curv_y = torch.sum((dw0[..., 0] ** 2 + dw1[..., 0] ** 2) * inv_b2, dim=-1)
    curv_x = torch.sum((dw0[..., 1] ** 2 + dw1[..., 1] ** 2) * inv_b2, dim=-1)
    curv = separable_filter(torch.stack([curv_y, curv_x], dim=-1), k, k, mode="same_zero")
    p_sim = (2.0 / (npix * c)) * curv
    p_tps = lam_n * 25.0
    p_quad = (2.0 / npix) * (p.gamma_ui * data.ui_w + p.beta_tc * data.tc_w)
    precond = p_sim + p_tps + p_quad + p.precond_eps / npix

    e_tps, e_ui, e_tc = quadratic_energies(v, data, p)
    energy = bundle.energy + e_tps + e_ui + e_tc
    return energy, grad, precond


def energy_value_grad_precond(v: torch.Tensor, data: LevelData, p: MorphParams):
    """E(v), dE/dv and the Gauss-Newton diagonal preconditioner at ``v``
    in one pass: the warps at ``v`` (kernel 3) and the sweep gradient on
    them (kernel 1), exact since ``v_lin = v``; the level solver's first
    iteration after each re-warp. ``E`` is a 0-d tensor on ``v``'s device."""
    return sweep_grad(halfway_warp(data.i0, data.i1, v), v, v, data, p)


def tps_adj_xx(a: torch.Tensor) -> torch.Tensor:
    """Self-adjoint second-difference stencil in x (zero outside)."""
    out = torch.zeros_like(a)
    out[:, 1:] += a[:, :-1]
    out += -2.0 * a
    out[:, :-1] += a[:, 1:]
    return out


def tps_adj_yy(a: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(a)
    out[1:, :] += a[:-1, :]
    out += -2.0 * a
    out[:-1, :] += a[1:, :]
    return out


def tps_adj_xy(a: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(a)
    out[1:, 1:] += 0.25 * a[:-1, :-1]
    out[1:, :-1] += -0.25 * a[:-1, 1:]
    out[:-1, 1:] += -0.25 * a[1:, :-1]
    out[:-1, :-1] += 0.25 * a[1:, 1:]
    return out


def _tps_grad_unnormalized(v: torch.Tensor) -> torch.Tensor:
    """d/dv of sum_p (|vxx|^2 + 2|vxy|^2 + |vyy|^2)."""
    vxx, vxy, vyy = tps_maps(v)
    return 2.0 * tps_adj_xx(vxx) + 4.0 * tps_adj_xy(vxy) + 2.0 * tps_adj_yy(vyy)


def pack_dtype_for(p: MorphParams, h: int, w: int, device) -> torch.dtype:
    """The dtype of the sweeps' static pack (kernel 3's planes and the UI/TC
    maps) on an h x w level whose tensors lie on ``device``: the reference's
    ``_resolve_backend`` read for this choice only. ``backend="jnp"``:
    float32; ``"pallas"``: ``p.pack_dtype``; ``"auto"``: ``p.pack_dtype`` on
    a CUDA device where ``h * w >= p.pallas_min_pixels`` (the reference's
    TPU rule), float32 elsewhere (its CPU path). An unknown ``backend``
    raises ``ValueError``, and so does an unknown ``pack_dtype`` where it
    is read."""
    if p.backend == "jnp":
        return torch.float32
    if p.backend == "auto":
        if torch.device(device).type != "cuda" or h * w < p.pallas_min_pixels:
            return torch.float32
    elif p.backend != "pallas":
        raise ValueError(f"unknown backend {p.backend!r}")
    return pack_dtype(p)


def _read(t: torch.Tensor):
    """``t``'s values on the host: a device-to-host read, counted as
    ``reads`` of the open level span and timed as a ``host.read`` span."""
    profiling.count("reads")
    with profiling.span("host.read"):
        return t.item() if t.numel() == 1 else t.tolist()


def level_masks(h: int, w: int, n_colors: int, dtype=torch.float32, device=None):
    """``(boundary mask, (colour mask, ...))`` of an h x w level: the
    :func:`boundary_mask` and the ``n_colors`` :func:`color_mask` maps,
    made once per level."""
    return (boundary_mask(h, w, dtype, device),
            tuple(color_mask(h, w, c, n_colors, dtype, device) for c in range(n_colors)))


class _Level:
    """A level's device state between two reads, which the steps below
    write in place: the field ``v``, the trial field ``v_try``, the step
    ``d``, the linearization (``planes``, ``v_lin``), the step length
    ``alpha`` (0-d), the read vector ``out`` (E(v), <grad, d>, E(v_try)),
    the level's data with its maps in the pack's dtype ``dt``, and the
    masks."""

    def __init__(self, v: torch.Tensor, data: LevelData, dt: torch.dtype, masks):
        self.v, self.data, self.dt = v, data, dt
        self.v_try, self.d, self.v_lin = torch.empty_like(v), torch.empty_like(v), torch.empty_like(v)
        self.planes = None
        self.alpha = v.new_zeros(())
        self.out = v.new_zeros((3,))
        self.bmask, self.cmasks = masks


def _median_step(s: _Level, p: MorphParams) -> None:
    """The re-warp's 3x3 median of the field, the boundary kept."""
    s.v.copy_(s.v + (median3x3(s.v) - s.v) * s.bmask)


def _warp_step(s: _Level, p: MorphParams) -> None:
    """Re-warp both images (kernel 3) at the field rounded to the pack's
    dtype, the linearization point ``v_lin``."""
    s.v_lin.copy_(s.v if s.dt == torch.float32 else quantize_v_lin(s.v, p))
    s.planes = halfway_warp(s.data.i0, s.data.i1, s.v_lin, s.dt)


def _try(s: _Level, p: MorphParams) -> torch.Tensor:
    """The linearized energy (kernel 2) at ``v_try = v + alpha d``, the
    product and the sum two float32 ops as with a Python ``alpha``."""
    torch.add(s.v, s.alpha * s.d, out=s.v_try)
    return sweep_energy(s.planes, s.v_lin, s.v_try, s.data, p)


def _iterate_step(s: _Level, p: MorphParams, color: int) -> None:
    """Energy, gradient and preconditioner at ``v`` (kernel 1), the step
    ``d`` masked to ``color`` and the boundary and clamped against
    foldover, and the first trial: ``out`` = (E(v), <grad, d>, E(v_try))."""
    e_cur, grad, precond = sweep_grad(s.planes, s.v_lin, s.v, s.data, p)
    d = (-grad / precond) * s.cmasks[color] * s.bmask
    s.d.copy_(foldover_scale(s.v, d, p.fold_margin))
    torch.stack([e_cur, torch.sum(grad * s.d), _try(s, p)], out=s.out)


def _trial_step(s: _Level, p: MorphParams) -> None:
    """A backtrack: ``out[2]`` = E(v_try) at the new ``alpha``."""
    s.out[2].copy_(_try(s, p))


def _steps(s: _Level, p: MorphParams) -> dict:
    """The level's steps by name, the warp first (the others read its
    planes): ``"warp"``, ``"median"`` (with ``relin_median``), one
    ``("iterate", colour)`` per colour, ``"trial"``."""
    steps = {"warp": lambda: _warp_step(s, p)}
    if p.relin_median:
        steps["median"] = lambda: _median_step(s, p)
    for c in range(len(s.cmasks)):
        steps[("iterate", c)] = lambda c=c: _iterate_step(s, p, c)
    steps["trial"] = lambda: _trial_step(s, p)
    return steps


def _load(s: _Level, v: torch.Tensor, data: LevelData) -> None:
    """Copy a call's field and data into a level's buffers (the maps cast
    to the pack's dtype as :func:`~videomorphing_tpu_torch.kernels.sweep.pack_maps` casts them)."""
    s.v.copy_(v)
    for buf, x in zip(s.data, data):
        buf.copy_(x)


class _OneDevice:
    """A level's operations for :func:`descend` on one device: ``go(name)``
    runs a step of :func:`_steps` on the buffers ``s``, as a graph replay
    where ``graphed`` (each iteration then counts as ``graph_iters``) or
    eagerly; ``field()`` is what the solve returns. ``on_card``: the sweeps
    launch the card's kernels."""

    def __init__(self, s: _Level, p: MorphParams, go, field, graphed: bool):
        self.s, self.p, self.go, self.field, self.graphed = s, p, go, field, graphed
        self.on_card = s.v.is_cuda

    def relin(self, median: bool) -> None:
        if median:
            self.go("median")
        self.go("warp")

    def iterate(self, color: int, alpha) -> tuple:
        self.s.alpha.fill_(float(alpha))
        self.go(("iterate", color))
        if self.graphed:
            profiling.count("graph_iters")
        return tuple(f32(x) for x in _read(self.s.out))

    def backtrack(self, alpha):
        self.s.alpha.fill_(float(alpha))
        self.go("trial")
        return f32(_read(self.s.out[2]))

    def accept(self) -> None:
        self.s.v.copy_(self.s.v_try)

    def energy(self):
        s = self.s
        return f32(_read(sweep_energy(s.planes, s.v_lin, s.v, s.data, self.p)))


def descend(open_level, p: MorphParams, n_iters: int, h: int, w: int):
    """The level loop of both level solvers: ``(v', LevelStats)`` of the
    level that ``open_level()`` makes, inside a ``solve.level`` span
    (``h``, ``w``, ``n_iters``, ``radius`` the sweep kernels' window radius
    R, on exit ``iters``) that counts ``armijo_trials`` (the first trial and
    each backtrack). Where the level's ``on_card`` says its sweeps launch
    the card's kernels, it also counts ``strip_iters``, the iterations whose
    gradient pass ran kernel 1's strip form, and ``strip_trials``, the
    trials whose energy pass ran kernel 2's strip form
    (:func:`~videomorphing_tpu_torch.kernels.sweep.strip`).

    The level does the device work and the reads: ``relin(median)`` (the
    field's 3x3 median where ``median``, then the re-warp),
    ``iterate(colour, alpha)`` (float32 (E(v), <grad, d>, E(v + alpha d))
    of the step of that colour), ``backtrack(alpha)`` (float32
    E(v + alpha d)), ``accept()`` (v <- the last trial), ``energy()``
    (float32 E(v)) and ``field()`` (v'). The loop makes every decision in
    float32, as the reference's ``lax.while_loop``.
    """
    armijo_c, shrink, grow = f32(p.armijo_c), f32(p.step_shrink), f32(p.step_grow)
    min_step, tol = f32(p.min_step), f32(p.tol)
    hist = torch.full((max(n_iters, 0),), float("nan"), dtype=torch.float32)
    step, e, e0 = f32(p.init_step), f32(0.0), f32(0.0)
    stall, it = 0, 0

    def cond():
        return it < n_iters and stall <= p.n_colors and step > min_step

    radius = int(p.ssim_window) // 2
    with profiling.span("solve.level", h=h, w=w, n_iters=n_iters, radius=radius) as span:
        level = open_level()
        strip_iter = level.on_card and strip(True, radius)
        strip_trial = level.on_card and strip(False, radius)
        if n_iters <= 0:
            level.relin(False)
            e0 = e = level.energy()
        relin = max(int(p.relin_every), 1)
        while cond():
            it0 = it
            level.relin(p.relin_median and it0 > 0)
            while cond() and it < it0 + relin:
                alpha = step
                e_cur, gd, e_try = level.iterate(it % p.n_colors, alpha)
                profiling.count("armijo_trials")
                if strip_iter:
                    profiling.count("strip_iters")
                if strip_trial:
                    profiling.count("strip_trials")
                if it == 0:
                    e0 = e_cur
                tries = 0
                while (e_try > e_cur + armijo_c * alpha * gd and tries < p.max_backtracks
                       and alpha > min_step):
                    alpha = alpha * shrink
                    e_try = level.backtrack(alpha)
                    profiling.count("armijo_trials")
                    if strip_trial:
                        profiling.count("strip_trials")
                    tries += 1
                accepted = e_try <= e_cur + armijo_c * alpha * gd
                if accepted:
                    level.accept()
                    e_new = e_try
                    step = alpha * grow if tries == 0 else alpha
                else:
                    e_new = e_cur
                    step = alpha * shrink
                rel_dec = (e_cur - e_new) / np.maximum(np.abs(e_cur), f32(1e-12))
                stall = stall + 1 if rel_dec < tol else 0
                hist[it] = float(e_new)
                e = e_new
                it += 1
        v = level.field()
        span.set(iters=it)
    return v, LevelStats(e0=float(e0), e_final=float(e), iters=it, step=float(step), energy_history=hist)


# ---------------------------------------------------------------------------
# the level's CUDA graphs
# ---------------------------------------------------------------------------

LEVEL_GRAPHS_KEPT = 12  # levels whose graphs are kept (a 4K pyramid has 8); the least recently used is freed first

# the MorphParams fields that the captured launches read; the others only steer the host's loop
GRAPH_FIELDS = ("ssim_window", "ssim_sigma", "ssim_c1", "ssim_c2", "ssim_use_luminance", "lambda_tps",
                "gamma_ui", "beta_tc", "precond_eps", "fold_margin", "n_colors", "relin_median")


def level_graph_key(device, stream, specs, pack: torch.dtype, p: MorphParams) -> tuple:
    """The cache key of a level's CUDA graphs: everything the captured
    launches depend on but the values of the field and the data. ``specs``:
    ``(shape, dtype)`` of ``v`` and of each ``LevelData`` field (H, W, C,
    the dtypes); ``stream``: the stream the replays run on; ``pack``: the
    sweeps' pack dtype (:func:`pack_dtype_for`); of ``p``, the
    :data:`GRAPH_FIELDS`."""
    return (device, stream, specs, pack, tuple(getattr(p, f) for f in GRAPH_FIELDS))


class _LevelGraphs(NamedTuple):
    state: _Level       # the buffers the graphs read and write
    graphs: Captured    # a graph per step of :func:`_steps`


_graphs = LRU(LEVEL_GRAPHS_KEPT)


def _capture_level(v: torch.Tensor, data: LevelData, p: MorphParams, dt: torch.dtype) -> _LevelGraphs:
    """Make a level's buffers and masks, load them, and capture every step
    (:func:`~videomorphing_tpu_torch.graphs.capture`) into one memory pool."""
    dev = v.device
    maps = ("ui_w", "ui_v", "tc_w", "tc_v")
    bufs = LevelData(**{k: torch.empty(x.shape, dtype=dt if k in maps else x.dtype, device=dev)
                        for k, x in data._asdict().items()})
    s = _Level(torch.empty(v.shape, dtype=v.dtype, device=dev), bufs, dt,
               level_masks(v.shape[0], v.shape[1], p.n_colors, v.dtype, dev))
    _load(s, v, data)
    graphs = capture(_steps(s, p), dev, COUNTED)
    profiling.count("graph_captures")
    return _LevelGraphs(s, graphs)


def _replaying(v: torch.Tensor, data: LevelData, p: MorphParams, dt: torch.dtype) -> _OneDevice:
    """A level as graph replays: the graphs of its key (captured on a miss)
    with the call's field and data loaded; each iteration replayed counts
    as ``graph_iters``, and the field returned is a copy."""
    dev = v.device
    specs = tuple((tuple(x.shape), x.dtype) for x in (v,) + tuple(data))
    key = level_graph_key(dev, torch.cuda.current_stream(dev).cuda_stream, specs, dt, p)
    entry = _graphs.get(key, lambda: _capture_level(v, data, p, dt))
    _load(entry.state, v, data)
    return _OneDevice(entry.state, p, entry.graphs.replay, entry.state.v.clone, graphed=True)


def make_level_solver(p: MorphParams, n_iters: int):
    """The per-level solve ``(v, data) -> (v', LevelStats)``: the loop of
    :func:`descend` on one device.

    Per outer block of ``relin_every`` iterations: 3x3-median the field
    (``relin_median``, skipped at the first block), re-warp both images
    (kernel 3) at the linearization point, rounded to the pack's dtype
    (:func:`pack_dtype_for`, :func:`~videomorphing_tpu_torch.kernels.sweep.quantize_v_lin`).
    Per iteration: energy, gradient and preconditioner (kernel 1); a masked,
    foldover-clamped preconditioned step; Armijo backtracking on the
    linearized energy (kernel 2 per trial). The host reads once an
    iteration, (E(v), <grad, d>) with the first trial's energy at the
    current step, and once a backtrack.

    On a card (every tensor on it, no capture open, no gradient wanted,
    ``n_iters`` > 0) each step between two reads is a replay of a CUDA
    graph, captured once per :func:`level_graph_key` and kept in an LRU of
    :data:`LEVEL_GRAPHS_KEPT` levels: an iteration of each colour, a
    backtrack, the re-warp and the median. The field and the data are
    copied into the graphs' buffers, the step length enters as a 0-d
    device tensor, and the field returned is a copy. Elsewhere the same
    steps run eagerly; both give the same bits. The ``solve.level`` span
    also counts ``reads`` (each a ``host.read`` span), ``graph_iters``
    (iterations replayed) and ``graph_captures``.
    """

    def eager(v: torch.Tensor, data: LevelData, dt: torch.dtype) -> _OneDevice:
        s = _Level(v.clone(memory_format=torch.contiguous_format), pack_maps(data, dt), dt,
                   level_masks(v.shape[0], v.shape[1], p.n_colors, v.dtype, v.device))
        steps = _steps(s, p)
        return _OneDevice(s, p, lambda name: steps[name](), lambda: s.v, graphed=False)

    def solve(v: torch.Tensor, data: LevelData):
        h, w = v.shape[0], v.shape[1]
        dt = pack_dtype_for(p, h, w, v.device)
        if n_iters > 0 and replayable((v,) + tuple(data)):
            with torch.cuda.device(v.device):
                return descend(lambda: _replaying(v, data, p, dt), p, n_iters, h, w)
        return descend(lambda: eager(v, data, dt), p, n_iters, h, w)

    return solve
