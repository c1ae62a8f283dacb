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
conditions and the Armijo test need, and does that scalar arithmetic in
float32 as the reference's ``lax.while_loop`` does.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from videomorphing_tpu_torch.config import MorphParams
from videomorphing_tpu_torch.kernels.sweep import pack_dtype, pack_maps, quantize_v_lin, sweep_energy, sweep_grad
from videomorphing_tpu_torch.kernels.warp import bundle_from_planes, halfway_warp
from videomorphing_tpu_torch.ops.ssim import dssim_grad_bundle, dssim_map
from videomorphing_tpu_torch.ops.windows import gaussian_taps, median3x3, separable_filter
from videomorphing_tpu_torch.solver.energy import LevelData, quadratic_energies, tps_maps

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
    at most ``margin`` (< 1/2) of its smallest neighbour gap per axis."""
    m_y = _axis_gaps(v[..., 0], 0)
    m_x = _axis_gaps(v[..., 1], 1)
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


def make_level_solver(p: MorphParams, n_iters: int):
    """The per-level solve ``(v, data) -> (v', LevelStats)``.

    Per outer block of ``relin_every`` iterations: 3x3-median the field
    (``relin_median``, skipped at the first block), re-warp both images
    (kernel 3) at the linearization point, rounded to the pack's dtype
    (:func:`pack_dtype_for`, :func:`~videomorphing_tpu_torch.kernels.sweep.quantize_v_lin`).
    Per iteration: energy, gradient and preconditioner (kernel 1); a masked,
    foldover-clamped preconditioned step; Armijo backtracking on the
    linearized energy (kernel 2 per trial).
    """
    armijo_c, shrink, grow = f32(p.armijo_c), f32(p.step_shrink), f32(p.step_grow)
    min_step, tol = f32(p.min_step), f32(p.tol)

    def solve(v: torch.Tensor, data: LevelData):
        h, w = v.shape[0], v.shape[1]
        v = v.contiguous()
        bmask = boundary_mask(h, w, v.dtype, v.device)
        hist = torch.full((max(n_iters, 0),), float("nan"), dtype=torch.float32)
        dt = pack_dtype_for(p, h, w, v.device)
        data_k = pack_maps(data, dt)

        def linearize(v_):
            """(the warp planes, v_lin) of a re-warp at ``v_``."""
            v_q = v_ if dt == torch.float32 else quantize_v_lin(v_, p)
            return halfway_warp(data.i0, data.i1, v_q, dt), v_q

        if n_iters <= 0:
            e0 = f32(sweep_energy(*linearize(v), v, data_k, p).item())
            return v, LevelStats(e0=float(e0), e_final=float(e0), iters=0,
                                 step=float(f32(p.init_step)), energy_history=hist)

        relin = max(int(p.relin_every), 1)
        step, e, e0 = f32(p.init_step), f32(0.0), f32(0.0)
        stall, it = 0, 0

        def cond():
            return it < n_iters and stall <= p.n_colors and step > min_step

        while cond():
            it0 = it
            if p.relin_median and it0 > 0:
                v = v + (median3x3(v) - v) * bmask
            planes, v_lin = linearize(v)
            while cond() and it < it0 + relin:
                e_cur_t, grad, precond = sweep_grad(planes, v_lin, v, data_k, p)
                cmask = color_mask(h, w, it % p.n_colors, p.n_colors, v.dtype, v.device)
                d = (-grad / precond) * cmask * bmask
                d = foldover_scale(v, d, p.fold_margin)
                e_cur, gd = (f32(x) for x in torch.stack([e_cur_t, torch.sum(grad * d)]).tolist())
                if it == 0:
                    e0 = e_cur

                def trial(alpha):
                    v_try = v + float(alpha) * d
                    return v_try, f32(sweep_energy(planes, v_lin, v_try, data_k, p).item())

                alpha = step
                v_try, e_try = trial(alpha)
                tries = 0
                while (e_try > e_cur + armijo_c * alpha * gd and tries < p.max_backtracks
                       and alpha > min_step):
                    alpha = alpha * shrink
                    v_try, e_try = trial(alpha)
                    tries += 1
                accepted = e_try <= e_cur + armijo_c * alpha * gd
                if accepted:
                    v, e_new = v_try, e_try
                    step = alpha * grow if tries == 0 else alpha
                else:
                    e_new = e_cur
                    step = alpha * shrink
                rel_dec = (e_cur - e_new) / np.maximum(np.abs(e_cur), f32(1e-12))
                stall = stall + 1 if rel_dec < tol else 0
                hist[it] = float(e_new)
                e = e_new
                it += 1

        return v, LevelStats(e0=float(e0), e_final=float(e), iters=it, step=float(step),
                             energy_history=hist)

    return solve
