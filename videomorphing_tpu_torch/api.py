"""Public library API: the image-pair and clip-pair morphs.

Port of ``videomorphing_tpu/api.py`` (``morph_pair``, ``solve_pair`` and
``morph_clips``; the multi-device ``mesh`` of ``morph_clips`` waits for the
parallel port).
Inputs may be numpy arrays or tensors; ``device`` says where the work runs
(default: the input tensor's device, or the CPU for numpy input). On a
CUDA device every kernel of the path is a hand-written CUDA kernel.

    from videomorphing_tpu_torch import api
    frames = api.morph_pair(i0, i1, points, n_frames=16, device="cuda")
    result = api.morph_clips(clip_a, clip_b, points, device="cuda")
"""

from __future__ import annotations

import numpy as np
import torch

from videomorphing_tpu_torch.config import MorphParams, SynthParams, VideoParams
from videomorphing_tpu_torch.device import as_device
from videomorphing_tpu_torch.models.image_morph import ImageMorpher, MorphArtifacts
from videomorphing_tpu_torch.models.video_morph import VideoMorpher
from videomorphing_tpu_torch.video.pipeline import VideoResult


def morph_pair(
    i0,
    i1,
    points=None,
    n_frames: int = 16,
    mp: MorphParams = MorphParams(),
    sp: SynthParams = SynthParams(),
    device=None,
) -> torch.Tensor:
    """Morph an image pair: (H, W, C) x2 -> (n_frames, H, W, C) on ``device``."""
    dev = _pick_device(i0, device)
    return ImageMorpher(mp, sp, str(dev))(_dev(i0, dev), _dev(i1, dev), _pts(points, dev), n_frames)


def solve_pair(i0, i1, points=None, mp=MorphParams(), sp=SynthParams(), device=None) -> MorphArtifacts:
    """Solve only (field + bulge), for callers that render separately."""
    dev = _pick_device(i0, device)
    return ImageMorpher(mp, sp, str(dev)).solve(_dev(i0, dev), _dev(i1, dev), _pts(points, dev))


def morph_clips(
    clip_a,
    clip_b,
    points=None,
    times=None,
    mp: MorphParams = MorphParams(),
    sp: SynthParams = SynthParams(),
    vp: VideoParams = VideoParams(),
    render: bool = True,
    device=None,
) -> VideoResult:
    """Morph a clip pair: (T, H, W, C) x2 -> ``VideoResult`` with frames
    (T, H, W, C) on ``device``. ``points``: (N, 2, 2) on frame 0, or a
    keyframe mapping ``{frame_idx: (N, 2, 2)}``."""
    dev = _pick_device(clip_a, device)
    return VideoMorpher(mp, sp, vp, str(dev))(
        _dev(clip_a, dev), _dev(clip_b, dev), _pts(points, dev), times=times, render=render
    )


def _pick_device(x, device) -> torch.device:
    if device is None and isinstance(x, torch.Tensor):
        return x.device
    return as_device(device)


def _dev(x, device) -> torch.Tensor:
    """Image to a contiguous float32 tensor on ``device`` (uint8 -> [0, 1])."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    if t.dtype == torch.uint8:
        t = t.to(torch.float32) / 255.0
    return t.to(device=device, dtype=torch.float32).contiguous()


def _pts(points, device):
    """Correspondences as an (N, 2, 2) float32 tensor of [[y0, x0], [y1, x1]],
    or a keyframe mapping ``{frame_idx: (N, 2, 2)}`` (video only; the same N
    point identities on every keyframe)."""
    if points is None:
        return None
    if isinstance(points, dict):
        out = {int(k): _pts(v, device) for k, v in points.items()}
        if len({p.shape[0] for p in out.values()}) > 1:
            raise ValueError("all keyframes must carry the same N point identities")
        return out
    t = points if isinstance(points, torch.Tensor) else torch.from_numpy(np.asarray(points, np.float32))
    t = t.to(device=device, dtype=torch.float32)
    if t.dim() != 3 or tuple(t.shape[1:]) != (2, 2):
        raise ValueError(f"points must be (N, 2, 2): [[y0,x0],[y1,x1]] pairs, got {tuple(t.shape)}")
    return t
