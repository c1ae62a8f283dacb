"""Layered image-pair morphing: one halfway field per layer plus the
background, composited bottom to top with morphed alphas.

Port of ``videomorphing_tpu/models/layered.py``. A layer is a pair of
masks (its region in image 0 and in image 1) with optional layer-local
points. Its field solves on NEUTRALIZED images (content outside the mask
replaced by the mask-interior mean colour), so the SSIM term sees only the
layer and the TPS term carries its motion smoothly past the silhouette.
The background solves on the full images. Each frame renders the
background with :func:`synth.render.render_frame`, then warps every layer
(image and mask together) along its own path and composites it with the
alpha ``(1-t) m0(phi0) + t m1(phi1)``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from videomorphing_tpu_torch.config import MorphParams, SynthParams
from videomorphing_tpu_torch.kernels.warp import bilinear_sample, bilinear_sample_batched
from videomorphing_tpu_torch.ops.resample import inside_mask
from videomorphing_tpu_torch.solver.ctf import optimize_pair
from videomorphing_tpu_torch.synth.blend import blend_extended
from videomorphing_tpu_torch.synth.paths import bulge_field
from videomorphing_tpu_torch.synth.render import invert_path, render_frame
from videomorphing_tpu_torch.video.pipeline import _default_times

f32 = np.float32


class Layer(NamedTuple):
    """One morph layer: masks in both images and optional local points."""

    mask0: torch.Tensor                    # (H, W) in [0, 1], image-0 region
    mask1: torch.Tensor                    # (H, W) in [0, 1], image-1 region
    points: Optional[torch.Tensor] = None  # (N, 2, 2) layer-local pairs


class LayeredArtifacts(NamedTuple):
    v_bg: torch.Tensor                     # background halfway field (H, W, 2)
    b_bg: Optional[torch.Tensor]
    v_layers: Tuple[torch.Tensor, ...]     # per-layer fields
    b_layers: Tuple[Optional[torch.Tensor], ...]


def neutralize(img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Replace content outside ``mask`` with the mask-interior mean colour:
    ``img`` (..., H, W, C), ``mask`` (..., H, W), each leading index (a
    clip's frame) on its own; the mean divides by ``max(sum(mask), 1)``."""
    m = mask[..., None]
    denom = torch.clamp(m.sum(dim=(-3, -2, -1), keepdim=True), min=1.0)
    mean = (img * m).sum(dim=(-3, -2), keepdim=True) / denom
    return img * m + mean * (1.0 - m)


def solve_layered(
    i0: torch.Tensor,
    i1: torch.Tensor,
    layers: Sequence[Layer],
    points: Optional[torch.Tensor] = None,
    mp: MorphParams = MorphParams(),
    sp: SynthParams = SynthParams(),
) -> LayeredArtifacts:
    """The background field (from ``points``) and one field per layer
    (from its own ``Layer.points``), each with its bulge."""
    res_bg = optimize_pair(i0, i1, points=points, params=mp)
    b_bg = bulge_field(res_bg.v, sp) if sp.quadratic_paths else None
    v_layers: List[torch.Tensor] = []
    b_layers: List[Optional[torch.Tensor]] = []
    for layer in layers:
        n0 = neutralize(i0, layer.mask0)
        n1 = neutralize(i1, layer.mask1)
        res = optimize_pair(n0, n1, points=layer.points, params=mp)
        v_layers.append(res.v)
        b_layers.append(bulge_field(res.v, sp) if sp.quadratic_paths else None)
    return LayeredArtifacts(v_bg=res_bg.v, b_bg=b_bg, v_layers=tuple(v_layers), b_layers=tuple(b_layers))


def _warp_layer(
    i0: torch.Tensor,
    i1: torch.Tensor,
    m0: torch.Tensor,
    m1: torch.Tensor,
    v: torch.Tensor,
    b: Optional[torch.Tensor],
    t,
    sp: SynthParams,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Morph one layer at time ``t``: ``(frame (H, W, C), alpha (H, W))``.

    The path inversion is followed by its own sample of ``v`` at ``p`` (not
    :func:`invert_path_with_field`, whose ``v`` is read at the penultimate
    iterate). Each mask rides its image as a last channel, and both
    mask-carrying images are sampled in one launch of the batched sampler,
    bilinearly whatever ``sp.sampling`` says.
    """
    h, w = i0.shape[0], i0.shape[1]
    t = f32(t)
    p = invert_path(v, b, t, sp.invert_iters, multiscale=sp.invert_multiscale)
    v_at_p = bilinear_sample(v, p)
    phi0 = p - v_at_p
    phi1 = p + v_at_p
    i0m = torch.cat([i0, m0[..., None]], -1)
    i1m = torch.cat([i1, m1[..., None]], -1)
    s0, s1 = bilinear_sample_batched(torch.stack([i0m, i1m]), torch.stack([phi0, phi1]))
    w0, a0 = s0[..., :-1], s0[..., -1]
    w1, a1 = s1[..., :-1], s1[..., -1]
    in0 = inside_mask(phi0, h, w)
    in1 = inside_mask(phi1, h, w)
    frame = blend_extended(w0, w1, in0 * (a0 > 0.01), in1 * (a1 > 0.01), float(t), sp)
    alpha = torch.clamp(float(f32(1.0) - t) * a0 * in0 + float(t) * a1 * in1, 0.0, 1.0)
    return frame, alpha


def composite_frame(i0, i1, v_bg, b_bg, layer_args, t, sp: SynthParams, conf0=None, conf1=None) -> torch.Tensor:
    """One layered frame: the background's :func:`render_frame`, then each
    layer ``(mask0, mask1, v, b)`` of ``layer_args`` over it, bottom to
    top, with its morphed alpha."""
    out = render_frame(i0, i1, v_bg, b_bg, t, sp, conf0=conf0, conf1=conf1)
    for m0, m1, v, b in layer_args:
        frame, alpha = _warp_layer(i0, i1, m0, m1, v, b, t, sp)
        out = out * (1.0 - alpha[..., None]) + frame * alpha[..., None]
    return out


def render_layered(
    i0: torch.Tensor,
    i1: torch.Tensor,
    layers: Sequence[Layer],
    art: LayeredArtifacts,
    ts,
    sp: SynthParams = SynthParams(),
) -> torch.Tensor:
    """The layered morph at times ``ts`` (K,) -> (K, H, W, C)."""
    ts = np.asarray(ts.detach().cpu() if isinstance(ts, torch.Tensor) else ts, np.float32).reshape(-1)
    layer_args = [(l.mask0, l.mask1, v, b) for l, v, b in zip(layers, art.v_layers, art.b_layers)]
    return torch.stack([composite_frame(i0, i1, art.v_bg, art.b_bg, layer_args, t, sp) for t in ts])


def morph_pair_layered(
    i0: torch.Tensor,
    i1: torch.Tensor,
    layers: Sequence[Layer],
    points: Optional[torch.Tensor] = None,
    n_frames: int = 16,
    mp: MorphParams = MorphParams(),
    sp: SynthParams = SynthParams(),
) -> torch.Tensor:
    """End-to-end layered image-pair morph -> (n_frames, H, W, C), at the
    reference's float32 ``linspace(0, 1, n_frames)`` times."""
    art = solve_layered(i0, i1, layers, points, mp, sp)
    return render_layered(i0, i1, layers, art, _default_times(n_frames, "cpu"), sp)
