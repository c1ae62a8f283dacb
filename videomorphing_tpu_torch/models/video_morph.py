"""Video morphing model [EGSR14]: flows + warm frame loop + synthesis.

Port of ``videomorphing_tpu/models/video_morph.py``; tensors are moved to
``device`` (default: clip A's card when it is a CUDA tensor, else the first
card).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from videomorphing_tpu_torch.config import MorphParams, SynthParams, VideoParams
from videomorphing_tpu_torch.device import pick_device
from videomorphing_tpu_torch.video.pipeline import VideoResult, morph_video, solve_clip_fields


@dataclasses.dataclass(frozen=True)
class VideoMorpher:
    """Configured video morpher.

    >>> morpher = VideoMorpher(device="cuda")
    >>> out = morpher(clip_a, clip_b, keyframe_points)
    >>> out.frames  # (T, H, W, C) morph transition
    """

    mp: MorphParams = MorphParams()
    sp: SynthParams = SynthParams()
    vp: VideoParams = VideoParams()
    device: Optional[str] = None

    def _put(self, clip_a, clip_b, points):
        dev = pick_device(self.device, clip_a)

        def put(x):
            if x is None:
                return None
            if isinstance(x, dict):
                return {k: put(v) for k, v in x.items()}
            return x.to(dev).contiguous()

        return put(clip_a), put(clip_b), put(points)

    def solve(self, clip_a, clip_b, points=None):
        """``(fields, tracked, flows)`` of :func:`solve_clip_fields`."""
        clip_a, clip_b, points = self._put(clip_a, clip_b, points)
        return solve_clip_fields(clip_a, clip_b, points, self.mp, self.vp)

    def __call__(self, clip_a, clip_b, points=None, times=None, render: bool = True, mesh=None) -> VideoResult:
        clip_a, clip_b, points = self._put(clip_a, clip_b, points)
        return morph_video(
            clip_a, clip_b, points=points, times=times,
            mp=self.mp, sp=self.sp, vp=self.vp, render=render, mesh=mesh,
        )
