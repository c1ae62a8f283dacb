"""Image-pair morphing model [TOG14]: solve + paths + render.

Port of ``videomorphing_tpu/models/image_morph.py``: two images and sparse
correspondences in, K in-between frames out, on ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from videomorphing_tpu_torch.config import MorphParams, SynthParams
from videomorphing_tpu_torch.solver.ctf import OptimizeResult, optimize_pair
from videomorphing_tpu_torch.synth.paths import bulge_field
from videomorphing_tpu_torch.synth.render import render_clip, render_frame


class MorphArtifacts(NamedTuple):
    """Everything needed to re-render without re-optimizing."""

    v: torch.Tensor                  # (H, W, 2) halfway field
    b: Optional[torch.Tensor]        # (H, W, 2) quadratic-path bulge
    result: Optional[OptimizeResult]


@dataclasses.dataclass(frozen=True)
class ImageMorpher:
    """Configured image-pair morpher; tensors are moved to ``device``.

    >>> morpher = ImageMorpher(device="cuda")
    >>> frames = morpher(i0, i1, points, n_frames=16)
    """

    mp: MorphParams = MorphParams()
    sp: SynthParams = SynthParams()
    device: str = "cpu"

    def _put(self, x):
        return None if x is None else x.to(torch.device(self.device)).contiguous()

    def solve(self, i0, i1, points=None, v0=None) -> MorphArtifacts:
        """Optimize the halfway field and the quadratic-path bulge;
        ``v0``: an optional full-resolution warm start (the solve then
        begins at the middle pyramid level)."""
        i0, i1, points, v0 = (self._put(x) for x in (i0, i1, points, v0))
        res = optimize_pair(i0, i1, points=points, params=self.mp, v0=v0)
        b = bulge_field(res.v, self.sp) if self.sp.quadratic_paths else None
        return MorphArtifacts(v=res.v, b=b, result=res)

    def render(self, i0, i1, art: MorphArtifacts, ts) -> torch.Tensor:
        i0, i1, v, b = (self._put(x) for x in (i0, i1, art.v, art.b))
        return render_clip(i0, i1, v, b, ts, self.sp)

    def render_one(self, i0, i1, art: MorphArtifacts, t) -> torch.Tensor:
        i0, i1, v, b = (self._put(x) for x in (i0, i1, art.v, art.b))
        return render_frame(i0, i1, v, b, t, self.sp)

    def __call__(self, i0, i1, points=None, n_frames: int = 16, include_endpoints: bool = True) -> torch.Tensor:
        art = self.solve(i0, i1, points)
        if include_endpoints:
            ts = np.linspace(0.0, 1.0, n_frames, dtype=np.float32)
        else:
            ts = ((np.arange(n_frames) + 1.0) / (n_frames + 1.0)).astype(np.float32)
        return self.render(i0, i1, art, ts)
