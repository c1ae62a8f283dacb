"""Quadratic motion paths from local rotation [TOG14 s5.1].

Port of ``videomorphing_tpu/synth/paths.py``: the closed-form rotational
bulge ``b* = tan(theta/4) R(-90) v``, clamped, then smoothed by one
screened-Poisson (DCT) solve. The path is
``x_t(p) = p + (2t - 1) v(p) + 4 t (1 - t) b(p)``.
"""

from __future__ import annotations


import torch

from vmbench.reference.config import SynthParams
from vmbench.reference.ops.poisson import screened_poisson_dct


def _cdiff(f: torch.Tensor, axis: int) -> torch.Tensor:
    """Central difference with one-sided differences at the edges."""
    g = (torch.roll(f, -1, axis) - torch.roll(f, 1, axis)) * 0.5
    if axis == 0:
        g[0] = f[1] - f[0]
        g[-1] = f[-1] - f[-2]
    else:
        g[:, 0] = f[:, 1] - f[:, 0]
        g[:, -1] = f[:, -1] - f[:, -2]
    return g


def rotation_angle_map(v: torch.Tensor) -> torch.Tensor:
    """Rotation angle theta(p) of the local map phi1 o phi0^{-1}, (H, W).

    J = (I + Dv)(I - Dv)^{-1}; theta = atan2(J10 - J01, J00 + J11).
    """
    p00, p01 = _cdiff(v[..., 0], 0), _cdiff(v[..., 0], 1)
    p10, p11 = _cdiff(v[..., 1], 0), _cdiff(v[..., 1], 1)
    a00, a01, a10, a11 = 1.0 + p00, p01, p10, 1.0 + p11
    b00, b01, b10, b11 = 1.0 - p00, -p01, -p10, 1.0 - p11
    det_b = b00 * b11 - b01 * b10
    det_b = torch.where(torch.abs(det_b) < 1e-6, torch.full_like(det_b, 1e-6), det_b)
    j00 = (a00 * b11 - a01 * b10) / det_b
    j01 = (-a00 * b01 + a01 * b00) / det_b
    j10 = (a10 * b11 - a11 * b10) / det_b
    j11 = (-a10 * b01 + a11 * b00) / det_b
    return torch.atan2(j10 - j01, j00 + j11)


def bulge_field(v: torch.Tensor, sp: SynthParams = SynthParams()) -> torch.Tensor:
    """Per-pixel quadratic-path bulge b(p), (H, W, 2)."""
    theta = rotation_angle_map(v)
    coef = torch.tan(torch.clamp(theta, -2.8, 2.8) * 0.25)
    perp = torch.stack([v[..., 1], -v[..., 0]], dim=-1)
    bstar = coef[..., None] * perp
    norm = torch.linalg.norm(bstar, dim=-1, keepdim=True)
    bstar = bstar * (torch.clamp(norm, max=sp.max_bulge) / torch.clamp(norm, min=1e-12))
    b = screened_poisson_dct(bstar, alpha=1.0, mu=sp.path_smooth_mu)
    return b.to(v.dtype)
