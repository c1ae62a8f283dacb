"""Poisson-extended blending [TOG14 s5.2].

Port of ``videomorphing_tpu/synth/blend.py``: each warped image is extended
past its valid region by pull-push, then the two are blended linearly or
with one screened gradient-domain (DCT) solve per frame.
"""

from __future__ import annotations

import torch

from videomorphing_tpu_torch.config import SynthParams
from videomorphing_tpu_torch.ops.poisson import (
    divergence,
    forward_gradients,
    pull_push_extend,
    screened_solve,
)


def blend_weights(t, m0: torch.Tensor, m1: torch.Tensor) -> torch.Tensor:
    """Per-pixel weight of image 1 in the blend, (H, W): (1-t, t) where both
    sources are valid, shifted toward the valid source elsewhere. (The
    reference's occlusion confidences serve the video pipeline.)"""
    a0 = (1.0 - t) * m0
    a1 = t * m1
    denom = a0 + a1
    return torch.where(denom > 1e-6, a1 / torch.clamp(denom, min=1e-6), torch.full_like(denom, t))


def blend_extended(
    w0: torch.Tensor,
    w1: torch.Tensor,
    m0: torch.Tensor,
    m1: torch.Tensor,
    t,
    sp: SynthParams = SynthParams(),
) -> torch.Tensor:
    """Blend two warped images (H, W, C) with validity masks (H, W) at time
    ``t`` (a float32 value), with Poisson extension past invalid regions."""
    w = blend_weights(t, m0, m1)[..., None]
    e0 = pull_push_extend(w0, m0, n_levels=sp.extend_levels)
    e1 = pull_push_extend(w1, m1, n_levels=sp.extend_levels)
    lin = (1.0 - w) * e0 + w * e1
    if sp.blend_mode == "linear":
        return lin
    # screened gradient-domain blend: (lam*I - Lap) x = lam*lin - div(g_mix)
    gy0, gx0 = forward_gradients(e0)
    gy1, gx1 = forward_gradients(e1)
    gy = (1.0 - w) * gy0 + w * gy1
    gx = (1.0 - w) * gx0 + w * gx1
    rhs = sp.blend_screen_lambda * lin - divergence(gy, gx)
    out = screened_solve(rhs, sp.blend_screen_lambda)
    return torch.clamp(out, 0.0, 1.0)
