"""Block-parallel clip solve: frame blocks across the mesh (port of
``videomorphing_tpu/parallel/video_blocks.py``).

The warm frame loop is sequential by construction, so a clip splits into
contiguous BLOCKS, one per device: every block's head frame solves cold
(the full pyramid) and the frames inside a block run the usual warm loop
from it. One cold solve per device instead of one per clip; at block seams
the temporal-coherence term then carries the head's fresh solve forward, as
frame 0 does for the whole clip.

The flows come in from ``video.pipeline.solve_clip_fields`` (sharded over
the mesh there). The blocks run one after another from this process, each
on its device; the fields gather on the clip's device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from videomorphing_tpu_torch.config import MorphParams, VideoParams
from videomorphing_tpu_torch.parallel.frames import shares
from videomorphing_tpu_torch.parallel.mesh import as_mesh
from videomorphing_tpu_torch.solver.ctf import optimize_pair
from videomorphing_tpu_torch.utils.profiling import note, phase_scope


def solve_clip_fields_blocked(
    clip_a: torch.Tensor,
    clip_b: torch.Tensor,
    tracked_points: torch.Tensor,
    flows: dict,
    mesh,
    mp: MorphParams = MorphParams(),
    vp: VideoParams = VideoParams(),
    axis: str = "batch",
) -> Tuple[torch.Tensor, int]:
    """Halfway fields of a clip with its frame blocks across the mesh.

    ``tracked_points`` (T, N, 2, 2) per-frame correspondences; ``flows``
    the flow dict of ``solve_clip_fields`` (the forward flows are read). T
    must divide over the mesh axis: ``solve_clip_fields`` pads a clip with
    repeats of its last frame (zero flow between them) and trims. Returns
    ``(fields (T, H, W, 2), iters)``, ``iters`` the optimizer iterations of
    every block's cold head and warm frames, padded repeats included.
    """
    from videomorphing_tpu_torch.video.pipeline import _frame_scan

    devs = as_mesh(mesh).axis_devices(axis)
    t_len, h, w = clip_a.shape[0], clip_a.shape[1], clip_a.shape[2]
    if t_len % len(devs):
        raise ValueError(f"clip length {t_len} must divide over {len(devs)} blocks")
    scan = _frame_scan(mp, vp, (h, w))
    fields, iters, warm_iters = [], 0, []
    for dev, sl in zip(devs, shares(t_len, len(devs))):
        a, b, pts = (x[sl].to(dev) for x in (clip_a, clip_b, tracked_points))
        with phase_scope("cold_solve"):
            res = optimize_pair(a[0], b[0], points=pts[0], params=mp)
        iters += sum(s.iters for s in res.level_stats)
        blk = [res.v]
        if a.shape[0] > 1:
            # block k's warm frames take the transitions k*block .. k*block + block - 2
            fa, fb = (flows[k][sl.start:sl.stop - 1].to(dev) for k in ("fa_fwd", "fb_fwd"))
            with phase_scope("warm_loop"):
                vs, its = scan(a[1:], b[1:], res.v, pts[1:], fa, fb)
            blk.append(vs)
            warm_iters += its
            iters += sum(its)
        fields.append(torch.cat([x.reshape((-1, h, w, 2)) for x in blk], 0).to(clip_a.device))
    note("warm_iters", warm_iters)
    return torch.cat(fields, 0), iters
