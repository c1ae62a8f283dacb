"""Coarse-to-fine pyramid loop of the halfway-domain solve [TOG14 s4].

Port of ``videomorphing_tpu/solver/ctf.py``. Levels run coarse to fine; each
level's constraint maps are rasterized at its own resolution and the field
is upsampled (values rescaled) into the next finer level.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from videomorphing_tpu_torch.config import MorphParams
from videomorphing_tpu_torch.ops.pyramid import (
    auto_n_levels,
    gaussian_pyramid,
    pyramid_shapes,
    resize_bilinear,
    upsample_field_2x,
)
from videomorphing_tpu_torch.solver.constraints import rasterize_point_constraints, scale_points
from videomorphing_tpu_torch.solver.descent import LevelStats, make_level_solver
from videomorphing_tpu_torch.solver.energy import make_level_data


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
) -> OptimizeResult:
    """Solve for the halfway field between ``i0`` and ``i1`` (H, W, C), cold
    from the coarsest level, on their device.

    ``points``: optional (N, 2, 2) full-resolution pairs ((y, x) in image 0,
    (y, x) in image 1). The reference's warm start (``v0``,
    ``start_level``) and temporal-coherence inputs (``tc_w``, ``tc_v``)
    serve the video pipeline and come with it.
    """
    h, w = i0.shape[0], i0.shape[1]
    dtype, device = i0.dtype, i0.device
    n_levels = params.n_levels or auto_n_levels(h, w, params.min_level_size)
    if points is None:
        points = torch.zeros((0, 2, 2), dtype=dtype, device=device)

    shapes = pyramid_shapes(h, w, n_levels)
    pyr0 = gaussian_pyramid(i0, n_levels)
    pyr1 = gaussian_pyramid(i1, n_levels)
    v = torch.zeros(shapes[-1] + (2,), dtype=dtype, device=device)

    stats = []
    for level in range(n_levels - 1, -1, -1):
        lh, lw = shapes[level]
        lpts = scale_points(points, (h, w), (lh, lw))
        ui_w, ui_v = rasterize_point_constraints(lpts, (lh, lw), params.ui_sigma, dtype, device)
        data = make_level_data(pyr0[level], pyr1[level], ui_w, ui_v)
        solve = make_level_solver(params, params.iters_for_level(level, n_levels))
        v, st = solve(v, data)
        stats.append(st)
        if level > 0:
            v = upsample_field_2x(v, shapes[level - 1])
    return OptimizeResult(v=v, level_stats=tuple(stats), n_levels=n_levels)
