"""Occlusion detection from forward/backward flow inconsistency [EGSR14 s5].

Port of ``videomorphing_tpu/video/occlusion.py``. A pixel visible in both
frames has flows that round-trip: fwd(p) + bwd(p + fwd(p)) ~ 0; where the
round-trip error is large the pixel is occluded in the next frame.
"""

from __future__ import annotations

import torch

from vmbench.reference.config import VideoParams
from vmbench.reference.kernels import bilinear_sample, bilinear_sample_batched
from vmbench.reference.ops.resample import grid_coords


def occlusion_confidence(
    flow_fwd: torch.Tensor,
    flow_bwd: torch.Tensor,
    vp: VideoParams = VideoParams(),
    use_fused: bool | None = None,
) -> torch.Tensor:
    """Per-pixel visibility confidence in [0, 1] (1 = consistent / visible).

    ``flow_fwd``: (H, W, 2) flow of this frame to the other; ``flow_bwd``:
    the reverse flow; or a batch of n such pairs, (n, H, W, 2) each, whose
    round-trip lookups run as one launch of kernel 4. Returns (H, W) or
    (n, H, W): a soft threshold on the round-trip error.

    ``use_fused`` is the reference's TPU dispatch knob; it is accepted and
    ignored, as ``VideoParams.fused_occlusion`` is: the lookup runs kernel
    4 whenever the flows lie on the card, and the result does not depend
    on it.
    """
    h, w = flow_fwd.shape[-3], flow_fwd.shape[-2]
    coords = grid_coords(h, w, dtype=flow_fwd.dtype, device=flow_fwd.device) + flow_fwd
    if flow_fwd.dim() == 4:
        bwd_at = bilinear_sample_batched(flow_bwd, coords)
    else:
        bwd_at = bilinear_sample(flow_bwd, coords)
    err = torch.linalg.vector_norm(flow_fwd + bwd_at, dim=-1)
    occ = torch.sigmoid((err - vp.occlusion_thresh) / max(vp.occlusion_soft, 1e-6))
    return 1.0 - occ
