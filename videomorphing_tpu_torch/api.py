"""Public library API: the image-pair, clip-pair and layered morphs, and
the interactive session.

Port of ``videomorphing_tpu/api.py``. Inputs may be numpy arrays or
tensors; ``device`` says where the work runs: by default the input's card
when it is a CUDA tensor, else the first card (raising when there is
none); the CPU only with ``device="cpu"``. On a CUDA device every kernel
of the path is a hand-written CUDA kernel. The clip morphs take a 1-D
``parallel.mesh.Mesh``: flows, frame blocks and the render are then
spread over its devices (``video.pipeline``).

    from videomorphing_tpu_torch import api
    frames = api.morph_pair(i0, i1, points, n_frames=16, device="cuda")
    result = api.morph_clips(clip_a, clip_b, points, device="cuda")
    frames = api.morph_pair_layered(i0, i1, [dict(mask0=m0, mask1=m1)], device="cuda")

``Session`` is the reference's interactive loop: edit the points, re-solve
warm-started from the current field, preview a frame.
"""

from __future__ import annotations

import numpy as np
import torch

from videomorphing_tpu_torch.config import MorphParams, SynthParams, VideoParams
from videomorphing_tpu_torch.device import pick_device
from videomorphing_tpu_torch.models.image_morph import ImageMorpher, MorphArtifacts
from videomorphing_tpu_torch.models.video_morph import VideoMorpher
from videomorphing_tpu_torch.models.layered import Layer
from videomorphing_tpu_torch.models.layered import morph_pair_layered as _morph_pair_layered
from videomorphing_tpu_torch.video.layered import LayeredVideoResult, VideoLayer
from videomorphing_tpu_torch.video.layered import morph_clips_layered as _morph_clips_layered
from videomorphing_tpu_torch.video.pipeline import VideoResult, _default_times


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
    dev = pick_device(device, i0)
    return ImageMorpher(mp, sp, str(dev))(_dev(i0, dev), _dev(i1, dev), _pts(points, dev), n_frames)


def solve_pair(i0, i1, points=None, mp=MorphParams(), sp=SynthParams(), device=None) -> MorphArtifacts:
    """Solve only (field + bulge), for callers that render separately."""
    dev = pick_device(device, i0)
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
    mesh=None,
    device=None,
) -> VideoResult:
    """Morph a clip pair: (T, H, W, C) x2 -> ``VideoResult`` with frames
    (T, H, W, C) on ``device``. ``points``: (N, 2, 2) on frame 0, or a
    keyframe mapping ``{frame_idx: (N, 2, 2)}``. ``mesh``: an optional 1-D
    ``parallel.mesh.Mesh``; frame BLOCKS then solve across its devices and
    the frames render across them."""
    dev = pick_device(device, clip_a)
    return VideoMorpher(mp, sp, vp, str(dev))(
        _dev(clip_a, dev), _dev(clip_b, dev), _pts(points, dev), times=times, render=render, mesh=mesh
    )


def morph_pair_layered(
    i0,
    i1,
    layers,
    points=None,
    n_frames: int = 16,
    mp: MorphParams = MorphParams(),
    sp: SynthParams = SynthParams(),
    device=None,
) -> torch.Tensor:
    """Layered morph: independently moving regions get their own fields.

    ``layers``: ``models.layered.Layer``s or dicts with keys ``mask0`` /
    ``mask1`` ((H, W) arrays; uint8 scales to [0, 1]) and an optional
    ``points``. Returns (n_frames, H, W, C) on ``device``.
    """
    dev = pick_device(device, i0)
    norm = [Layer(*_layer_parts(l, dev)) for l in layers]
    return _morph_pair_layered(_dev(i0, dev), _dev(i1, dev), norm, _pts(points, dev), n_frames, mp, sp)


def morph_clips_layered(
    clip_a,
    clip_b,
    layers,
    points=None,
    times=None,
    mp: MorphParams = MorphParams(),
    sp: SynthParams = SynthParams(),
    vp: VideoParams = VideoParams(),
    mesh=None,
    device=None,
) -> LayeredVideoResult:
    """Layered video morph: independently moving regions of a clip pair get
    their own temporally propagated fields (``video.layered``).

    ``layers``: ``video.layered.VideoLayer``s or dicts with keys ``mask0`` /
    ``mask1`` ((T, H, W) or (H, W) arrays) and an optional ``points`` (the
    forms of ``morph_clips``). ``mesh``: as for ``morph_clips``, for the
    background's and every layer's solve.
    """
    dev = pick_device(device, clip_a)
    norm = [VideoLayer(*_layer_parts(l, dev)) for l in layers]
    return _morph_clips_layered(
        _dev(clip_a, dev), _dev(clip_b, dev), norm, _pts(points, dev), times=times, mp=mp, sp=sp, vp=vp,
        mesh=mesh,
    )


class Session:
    """Interactive morphing session with warm restarts on point edits."""

    def __init__(self, i0, i1, mp: MorphParams = MorphParams(), sp: SynthParams = SynthParams(), device=None):
        self.device = pick_device(device, i0)
        self.i0 = _dev(i0, self.device)
        self.i1 = _dev(i1, self.device)
        self.morpher = ImageMorpher(mp, sp, str(self.device))
        self.points = None
        self.art = None

    def update_points(self, points) -> MorphArtifacts:
        """Re-solve with edited points, warm-started from the current field."""
        self.points = _pts(points, self.device)
        v0 = self.art.v if self.art is not None else None
        self.art = self.morpher.solve(self.i0, self.i1, self.points, v0=v0)
        return self.art

    def solve(self) -> MorphArtifacts:
        if self.art is None:
            self.art = self.morpher.solve(self.i0, self.i1, self.points)
        return self.art

    def preview(self, t: float = 0.5) -> torch.Tensor:
        """One frame at time ``t``."""
        return self.morpher.render_one(self.i0, self.i1, self.solve(), t)

    def render(self, n_frames: int = 16) -> torch.Tensor:
        """``n_frames`` frames at the reference's float32 ``linspace(0, 1)``."""
        return self.morpher.render(self.i0, self.i1, self.solve(), _default_times(n_frames, "cpu"))


def _dev(x, device) -> torch.Tensor:
    """Image to a contiguous float32 tensor on ``device`` (uint8 -> [0, 1])."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    if t.dtype == torch.uint8:
        t = t.to(torch.float32) / 255.0
    return t.to(device=device, dtype=torch.float32).contiguous()


def _layer_parts(layer, device):
    """``(mask0, mask1, points)`` of a layer (a ``Layer``/``VideoLayer`` or a
    dict), normalized as the images and points are, on ``device``."""
    get = layer.get if isinstance(layer, dict) else lambda k: getattr(layer, k)
    return _dev(get("mask0"), device), _dev(get("mask1"), device), _pts(get("points"), device)


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
