"""Project files: the JSON rebuild of the reference's XML project format.

A copy of ``videomorphing_tpu/io/project.py`` against this package's
``config``, so a project loads to the port's parameter dataclasses.

The reference's MdiEditor persists input paths, energy weights and the user's
point pairs to a project XML (SURVEY.md section 3 "Project/config"); the
rebuild uses a JSON schema plus the frozen dataclass configs so a project is
the complete, reproducible description of a morph job.

Schema (all sections optional except sources):
{
  "source_a": "clipA.vmc" | "a.png",      # image or clip path
  "source_b": "...",
  "points": [[[y0,x0],[y1,x1]], ...],      # full-res correspondence pairs
  "keyframes": {"0": [...], "12": [...]},  # video: per-keyframe point sets
                                           # (same N identities, flow-tracked
                                           # between keyframes [EGSR14 s3])
  "n_frames": 16,                          # image-pair mode
  "times": [t0, t1, ...],                  # optional explicit schedule
  "layers": [                              # optional morph layers (image mode)
    {"mask_a": "m0.png", "mask_b": "m1.png",
     "points": [[[y0,x0],[y1,x1]], ...]},  # layer-local correspondences
    ...                                    # bottom-to-top compositing order
  ],
  "morph": {"lambda_tps": ..., ...},       # MorphParams overrides
  "synth": {...},                          # SynthParams overrides
  "video": {...},                          # VideoParams overrides
  "output": "out_dir_or.npz"
}
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from videomorphing_tpu_torch.config import MorphParams, SynthParams, VideoParams


@dataclasses.dataclass
class Project:
    source_a: str
    source_b: str
    points: Any = None   # (N, 2, 2) float32, or {frame_idx: (N, 2, 2)} keyframes
    layers: Optional[List[Dict[str, Any]]] = None  # [{mask_a, mask_b, points}]
    n_frames: int = 16
    times: Optional[np.ndarray] = None
    morph: MorphParams = MorphParams()
    synth: SynthParams = SynthParams()
    video: VideoParams = VideoParams()
    output: str = "morph_out"

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "source_a": self.source_a,
            "source_b": self.source_b,
            "n_frames": self.n_frames,
            "output": self.output,
            "morph": _overrides(self.morph, MorphParams()),
            "synth": _overrides(self.synth, SynthParams()),
            "video": _overrides(self.video, VideoParams()),
        }
        if isinstance(self.points, dict):
            d["keyframes"] = {
                str(k): np.asarray(v).tolist() for k, v in self.points.items()
            }
        elif self.points is not None and len(self.points):
            d["points"] = np.asarray(self.points).tolist()
        if self.times is not None:
            d["times"] = np.asarray(self.times).tolist()
        if self.layers:
            d["layers"] = self.layers
        return d


def _overrides(cfg, default) -> Dict[str, Any]:
    out = {}
    for f in dataclasses.fields(cfg):
        val = getattr(cfg, f.name)
        if val != getattr(default, f.name):
            out[f.name] = val
    return out


def _apply(cls, base, overrides: Dict[str, Any]):
    if not overrides:
        return base
    return dataclasses.replace(base, **overrides)


def load_project(path: str) -> Project:
    with open(path) as f:
        d = json.load(f)
    points = None
    if d.get("keyframes"):
        points = {}
        for k, v in d["keyframes"].items():
            p = np.asarray(v, np.float32)
            if p.ndim != 3 or p.shape[1:] != (2, 2):
                raise ValueError(f"keyframe {k}: points must be [[y0,x0],[y1,x1]] pairs")
            points[int(k)] = p
    elif d.get("points"):
        points = np.asarray(d["points"], np.float32)
        if points.ndim != 3 or points.shape[1:] != (2, 2):
            raise ValueError("points must be a list of [[y0,x0],[y1,x1]] pairs")
    times = np.asarray(d["times"], np.float32) if d.get("times") else None
    return Project(
        source_a=d["source_a"],
        source_b=d["source_b"],
        points=points,
        n_frames=int(d.get("n_frames", 16)),
        times=times,
        layers=d.get("layers"),
        morph=_apply(MorphParams, MorphParams(), d.get("morph", {})),
        synth=_apply(SynthParams, SynthParams(), d.get("synth", {})),
        video=_apply(VideoParams, VideoParams(), d.get("video", {})),
        output=d.get("output", "morph_out"),
    )


def save_project(path: str, project: Project) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(project.to_dict(), f, indent=2)
