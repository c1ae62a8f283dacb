"""Sparse user correspondences -> per-level constraint maps [TOG14 s3.3].

Port of ``videomorphing_tpu/solver/constraints.py``. A pair (q0, q1) of
full-resolution (y, x) points implies the halfway anchor (q0 + q1)/2 with
target vector (q1 - q0)/2.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vmbench.reference.ops.resample import grid_coords


def scale_points(points: torch.Tensor, full_hw: Tuple[int, int], level_hw: Tuple[int, int]) -> torch.Tensor:
    """Rescale (N, 2, 2) point pairs from full-res coordinates to a level."""
    if points.shape[0] == 0:
        return points
    sy = level_hw[0] / full_hw[0]
    sx = level_hw[1] / full_hw[1]
    return points * torch.tensor([sy, sx], dtype=points.dtype, device=points.device)


def rasterize_point_constraints(
    points: torch.Tensor,
    hw: Tuple[int, int],
    sigma: float,
    dtype=torch.float32,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gaussian-falloff weight map (H, W, 1) in [0, 1] and weight-blended
    target field (H, W, 2) of point pairs in this level's coordinates."""
    h, w = hw
    if points.shape[0] == 0:
        return (
            torch.zeros((h, w, 1), dtype=dtype, device=device),
            torch.zeros((h, w, 2), dtype=dtype, device=device),
        )
    points = points.to(dtype)
    anchors = 0.5 * (points[:, 0] + points[:, 1])
    targets = 0.5 * (points[:, 1] - points[:, 0])
    g = grid_coords(h, w, dtype=dtype, device=points.device)
    d = g[None] - anchors[:, None, None, :]
    d2 = torch.sum(d * d, dim=-1)
    wts = torch.exp(-0.5 * d2 / (sigma * sigma))
    wsum = torch.sum(wts, dim=0)
    vt = torch.einsum("nhw,nc->hwc", wts, targets) / torch.clamp(wsum, min=1e-12)[..., None]
    w_map = torch.clamp(wsum, 0.0, 1.0)
    return w_map[..., None].contiguous(), vt.contiguous()
