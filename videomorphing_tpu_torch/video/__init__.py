"""The video morph [EGSR14]: flows, temporal propagation, occlusion and the
warm frame loop (port of ``videomorphing_tpu/video``)."""

from videomorphing_tpu_torch.video.flow import flow_pair, clip_flows
from videomorphing_tpu_torch.video.occlusion import occlusion_confidence
from videomorphing_tpu_torch.video.temporal import advect_halfway_field
from videomorphing_tpu_torch.video.pipeline import (
    solve_clip_fields,
    morph_video,
    VideoResult,
)

__all__ = [
    "flow_pair",
    "clip_flows",
    "occlusion_confidence",
    "advect_halfway_field",
    "solve_clip_fields",
    "morph_video",
    "VideoResult",
]
