"""Poisson-extended, occlusion-aware blending [TOG14 s5.2; EGSR14 s5].

Port of ``videomorphing_tpu/synth/blend.py``: each warped image is extended
past its valid region by pull-push, then the two are blended linearly or
with one screened gradient-domain (DCT) solve per frame.
"""

from __future__ import annotations

from typing import Optional

import torch

from videomorphing_tpu_torch.config import SynthParams
from videomorphing_tpu_torch.ops.poisson import (
    divergence,
    forward_gradients,
    pull_push_extend,
    screened_solve,
)


def blend_weights(
    t,
    m0: torch.Tensor,
    m1: torch.Tensor,
    conf0: Optional[torch.Tensor] = None,
    conf1: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-pixel weight of image 1 in the blend, (H, W): (1-t, t) where both
    sources are valid and visible, shifted toward the valid, un-occluded
    source elsewhere (``conf0``/``conf1``: per-source visibility maps from
    ``video.occlusion``)."""
    return blend_weights_of(1.0 - t, t, m0, m1, conf0, conf1)


def blend_weights_of(f0, f1, m0, m1, conf0=None, conf1=None) -> torch.Tensor:
    """:func:`blend_weights` from the sources' factors ``f0`` = 1 - t and
    ``f1`` = t: Python numbers, or 0-d tensors on the masks' device (a
    captured frame reads its time from the device)."""
    a0 = f0 * m0
    a1 = f1 * m1
    if conf0 is not None:
        a0 = a0 * conf0
    if conf1 is not None:
        a1 = a1 * conf1
    denom = a0 + a1
    return torch.where(denom > 1e-6, a1 / torch.clamp(denom, min=1e-6), f1)


def blend_extended(
    w0: torch.Tensor,
    w1: torch.Tensor,
    m0: torch.Tensor,
    m1: torch.Tensor,
    t,
    sp: SynthParams = SynthParams(),
    conf0: Optional[torch.Tensor] = None,
    conf1: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Blend two warped images (H, W, C) with validity masks (H, W) and
    optional visibility confidences (H, W) at time ``t`` (a float32 value),
    with Poisson extension past invalid regions."""
    return blend_with_weights(w0, w1, m0, m1, blend_weights(t, m0, m1, conf0, conf1), sp)


def blend_with_weights(
    w0: torch.Tensor,
    w1: torch.Tensor,
    m0: torch.Tensor,
    m1: torch.Tensor,
    weight: torch.Tensor,
    sp: SynthParams = SynthParams(),
) -> torch.Tensor:
    """:func:`blend_extended` with the weight of image 1 given, (H, W)."""
    w = weight[..., None]
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
