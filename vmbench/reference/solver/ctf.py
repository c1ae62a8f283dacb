"""Coarse-to-fine pyramid loop of the halfway-domain solve [TOG14 s4].

Port of ``videomorphing_tpu/solver/ctf.py``. Levels run coarse to fine; each
level's constraint maps are rasterized at its own resolution and the field
is upsampled (values rescaled) into the next finer level.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from vmbench.reference.config import MorphParams
from vmbench.reference.ops.pyramid import (
    auto_n_levels,
    downsample_to,
    gaussian_pyramid,
    pyramid_shapes,
    resize_bilinear,
    upsample_field_2x,
)
from vmbench.reference.solver.constraints import rasterize_point_constraints, scale_points
from vmbench.reference.kernels import halfway_warp, sweep_energy
from vmbench.reference.solver.descent import LevelStats, make_level_solver
from vmbench.reference.solver.energy import make_level_data


class OptimizeResult(NamedTuple):
    v: torch.Tensor                      # (H, W, 2) converged halfway field
    level_stats: Tuple[LevelStats, ...]  # coarse -> fine order
    n_levels: int


def resample_field(v: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Resize a displacement field to (H, W), rescaling vector magnitudes."""
    h0, w0 = v.shape[0], v.shape[1]
    out = resize_bilinear(v, hw)
    return out * torch.tensor([hw[0] / h0, hw[1] / w0], dtype=v.dtype, device=v.device)


def optimize_pair(
    i0: torch.Tensor,
    i1: torch.Tensor,
    points: Optional[torch.Tensor] = None,
    params: MorphParams = MorphParams(),
    v0: Optional[torch.Tensor] = None,
    tc_w: Optional[torch.Tensor] = None,
    tc_v: Optional[torch.Tensor] = None,
    start_level: Optional[int] = None,
    min_iters: Optional[Tuple[int, ...]] = None,
) -> OptimizeResult:
    """Solve for the halfway field between ``i0`` and ``i1`` (H, W, C) on
    their device.

    ``points``: optional (N, 2, 2) full-resolution pairs ((y, x) in image 0,
    (y, x) in image 1). ``v0``: optional full-resolution warm start.
    ``tc_w``/``tc_v``: optional full-resolution temporal-coherence weight
    ((H, W) or (H, W, 1)) and target field, used only together.
    ``start_level``: the coarsest level solved (default: the coarsest when
    cold, the middle level ``(n_levels - 1) // 2`` when warm-started).
    ``min_iters``: per level solved, coarse to fine, the iterations each
    runs at least before its stopping rule is tested (to follow another
    solve's ``LevelStats.iters``).
    """
    h, w = i0.shape[0], i0.shape[1]
    dtype, device = i0.dtype, i0.device
    n_levels = params.n_levels or auto_n_levels(h, w, params.min_level_size)
    if points is None:
        points = torch.zeros((0, 2, 2), dtype=dtype, device=device)
    if start_level is None:
        start_level = (n_levels - 1) if v0 is None else max((n_levels - 1) // 2, 0)
    start_level = min(start_level, n_levels - 1)
    with_tc = tc_w is not None and tc_v is not None
    if with_tc and tc_w.dim() == 2:
        tc_w = tc_w[..., None]

    shapes = pyramid_shapes(h, w, n_levels)
    pyr0 = gaussian_pyramid(i0, n_levels)
    pyr1 = gaussian_pyramid(i1, n_levels)
    if v0 is not None:
        v = resample_field(v0.to(dtype), shapes[start_level])
    else:
        v = torch.zeros(shapes[start_level] + (2,), dtype=dtype, device=device)

    stats = []
    for level in range(start_level, -1, -1):
        lh, lw = shapes[level]
        lpts = scale_points(points, (h, w), (lh, lw))
        ui_w, ui_v = rasterize_point_constraints(lpts, (lh, lw), params.ui_sigma, dtype, device)
        ltc_w = downsample_to(tc_w, (lh, lw)) if with_tc else None
        ltc_v = resample_field(tc_v.to(dtype), (lh, lw)) if with_tc else None
        data = make_level_data(pyr0[level], pyr1[level], ui_w, ui_v, ltc_w, ltc_v)
        floor = 0 if min_iters is None else int(min_iters[start_level - level])
        solve = make_level_solver(params, params.iters_for_level(level, n_levels), floor)
        v, st = solve(v, data)
        stats.append(st)
        if level > 0:
            v = upsample_field_2x(v, shapes[level - 1])
    return OptimizeResult(v=v, level_stats=tuple(stats), n_levels=n_levels)


def field_energy(i0: torch.Tensor, i1: torch.Tensor, v: torch.Tensor,
                 points: Optional[torch.Tensor] = None, params: MorphParams = MorphParams()) -> float:
    """The energy E(v) of a full-resolution halfway field ``v`` for the pair
    ``i0``, ``i1`` (H, W, C), with ``points`` as user constraints: the
    finest level's energy, the warps taken at ``v`` itself (exact, not
    linearized), in float32."""
    h, w = i0.shape[0], i0.shape[1]
    if points is None:
        points = torch.zeros((0, 2, 2), dtype=i0.dtype, device=i0.device)
    ui_w, ui_v = rasterize_point_constraints(scale_points(points, (h, w), (h, w)), (h, w),
                                             params.ui_sigma, i0.dtype, i0.device)
    data = make_level_data(i0, i1, ui_w, ui_v)
    v = v.to(device=i0.device, dtype=i0.dtype).contiguous()
    return float(sweep_energy(halfway_warp(i0, i1, v), v, v, data, params))
