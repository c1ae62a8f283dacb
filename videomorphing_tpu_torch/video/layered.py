"""Layered video morphing: per-layer fields through the warm frame loop.

Port of ``videomorphing_tpu/video/layered.py``. Each :class:`VideoLayer`
carries per-frame masks in both clips (an (H, W) mask holds for every
frame). A layer's fields solve on NEUTRALIZED clips (``models.layered``
semantics) through the same :func:`solve_clip_fields` as the background, so
their flows follow the layer's own motion and the temporal advection is per
layer. The render keeps the flows of the full clips for the occlusion
confidences, renders the background frame and composites the layers over
it, bottom to top, one frame at a time.

Stages, each a ``utils.profiling.phase_scope``: the background's and every
layer's ``solve_clip_fields`` stages (a layer's solve also counts under
``layer_solve``), ``bulges``, ``confidences`` and ``render``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from videomorphing_tpu_torch.config import MorphParams, SynthParams, VideoParams
from videomorphing_tpu_torch.models.layered import composite_frame, neutralize
from videomorphing_tpu_torch.utils.profiling import phase_scope
from videomorphing_tpu_torch.video.pipeline import (
    _clip_confidences,
    _default_times,
    clip_bulges,
    render_video,
    solve_clip_fields,
)


class VideoLayer(NamedTuple):
    """One video morph layer: per-frame masks in both clips."""

    mask0: torch.Tensor              # (T, H, W) or (H, W) region in clip A
    mask1: torch.Tensor              # (T, H, W) or (H, W) region in clip B
    points: Optional[object] = None  # the point forms of solve_clip_fields


class LayeredVideoResult(NamedTuple):
    fields_bg: torch.Tensor                   # (T, H, W, 2)
    fields_layers: Tuple[torch.Tensor, ...]   # per-layer (T, H, W, 2)
    frames: Optional[torch.Tensor]            # (T, H, W, C) composite


def _masks_t(mask: torch.Tensor, t_len: int) -> torch.Tensor:
    """A layer mask as (T, H, W): an (H, W) mask is broadcast over T."""
    return mask[None].expand((t_len,) + tuple(mask.shape)) if mask.dim() == 2 else mask


def solve_clip_fields_layered(
    clip_a: torch.Tensor,
    clip_b: torch.Tensor,
    layers: Sequence[VideoLayer],
    points=None,
    mp: MorphParams = MorphParams(),
    vp: VideoParams = VideoParams(),
    mesh=None,
):
    """Background and per-layer halfway fields of a clip pair:
    ``(fields_bg, fields_layers, flows)``. ``flows`` are the FULL clips'
    flows (the render's occlusion confidences read them); the flows of the
    neutralized clips are dropped. A ``mesh`` serves every solve (the
    background's and each layer's), as the reference's."""
    t_len = clip_a.shape[0]
    fields_bg, _tracked, flows = solve_clip_fields(clip_a, clip_b, points, mp, vp, mesh=mesh)
    fields_layers = []
    for layer in layers:
        with phase_scope("layer_solve"):
            na = neutralize(clip_a, _masks_t(layer.mask0, t_len))
            nb = neutralize(clip_b, _masks_t(layer.mask1, t_len))
            f, _, _ = solve_clip_fields(na, nb, layer.points, mp, vp, mesh=mesh)
            del na, nb
        fields_layers.append(f)
    return fields_bg, tuple(fields_layers), flows


def render_clips_layered(
    clip_a: torch.Tensor,
    clip_b: torch.Tensor,
    layers: Sequence[VideoLayer],
    fields_bg: torch.Tensor,
    fields_layers: Sequence[torch.Tensor],
    flows: dict,
    times=None,
    sp: SynthParams = SynthParams(),
    vp: VideoParams = VideoParams(),
) -> torch.Tensor:
    """The layered composite (T, H, W, C) from solved fields and the full
    clips' ``flows``: background bulges through :func:`render_video`
    (``render=False``), confidences from the flows, per-layer bulges, then
    one :func:`models.layered.composite_frame` per frame."""
    t_len = clip_a.shape[0]
    if times is None:
        times = _default_times(t_len, clip_a.device)
    times = np.asarray(torch.as_tensor(times).detach().cpu(), np.float32).reshape(-1)
    res_bg = render_video(clip_a, clip_b, fields_bg, times=times, sp=sp, vp=vp, flows=flows, render=False)
    b_bg = res_bg.bulges if res_bg.bulges is not None else torch.zeros_like(fields_bg)
    with phase_scope("confidences"):
        if sp.occlusion_weighting and t_len > 1:
            conf_a = _clip_confidences(flows["fa_fwd"], flows["fa_bwd"], t_len, vp)
            conf_b = _clip_confidences(flows["fb_fwd"], flows["fb_bwd"], t_len, vp)
        else:
            conf_a = conf_b = clip_a.new_ones(clip_a.shape[:3])
    with phase_scope("bulges"):
        layer_xs = [
            (
                _masks_t(layer.mask0, t_len).to(clip_a.dtype),
                _masks_t(layer.mask1, t_len).to(clip_a.dtype),
                f,
                clip_bulges(f, sp) if sp.quadratic_paths else torch.zeros_like(f),
            )
            for layer, f in zip(layers, fields_layers)
        ]
    with phase_scope("render"):
        frames = torch.empty_like(clip_a)
        for t in range(t_len):
            layer_args = [(m0[t], m1[t], v[t], b[t]) for m0, m1, v, b in layer_xs]
            frames[t] = composite_frame(
                clip_a[t], clip_b[t], fields_bg[t], b_bg[t], layer_args, times[t], sp,
                conf0=conf_a[t], conf1=conf_b[t],
            )
    return frames


def morph_clips_layered(
    clip_a: torch.Tensor,
    clip_b: torch.Tensor,
    layers: Sequence[VideoLayer],
    points=None,
    times=None,
    mp: MorphParams = MorphParams(),
    sp: SynthParams = SynthParams(),
    vp: VideoParams = VideoParams(),
    mesh=None,
) -> LayeredVideoResult:
    """End-to-end layered video morph -> (T, H, W, C) composite frames; the
    ``mesh`` serves the solves (the composite renders on one device, as the
    reference's)."""
    fields_bg, fields_layers, flows = solve_clip_fields_layered(clip_a, clip_b, layers, points, mp, vp, mesh)
    frames = render_clips_layered(
        clip_a, clip_b, layers, fields_bg, fields_layers, flows, times=times, sp=sp, vp=vp
    )
    return LayeredVideoResult(fields_bg=fields_bg, fields_layers=fields_layers, frames=frames)
