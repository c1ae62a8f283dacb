"""The video pipeline: flows once, frame 0 cold, then a warm loop over
frames carrying the converged field [EGSR14]; then bulges, occlusion
confidences and the render.

A frozen copy of the program's single-device path, without the mesh
forms and without phase ranges.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from vmbench.reference.config import MorphParams, SynthParams, VideoParams
from vmbench.reference.ops.pyramid import downsample_2x, pyramid_shapes
from vmbench.reference.solver.constraints import rasterize_point_constraints, scale_points
from vmbench.reference.solver.ctf import resample_field
from vmbench.reference.solver.descent import make_level_solver
from vmbench.reference.solver.energy import make_level_data
from vmbench.reference.synth.paths import bulge_field
from vmbench.reference.synth.render import render_frame
from vmbench.reference.video.flow import clip_flows
from vmbench.reference.video.occlusion import occlusion_confidence
from vmbench.reference.video.temporal import advect_halfway_field, track_keyframe_points


def warm_level_count(hw: Tuple[int, int], vp: VideoParams) -> int:
    """Resolve ``vp.warm_levels`` (0 = auto): 1 level (full resolution only)
    up to 2.4 Mpx, 3 above; clamped so the coarsest level stays >= 8 px."""
    h, w = hw
    n = vp.warm_levels or (1 if h * w <= 2_400_000 else 3)
    n = max(1, n)
    while n > 1 and min(pyramid_shapes(h, w, n)[n - 1]) < 8:
        n -= 1
    return n


def _make_warm_solver(mp: MorphParams, hw: Tuple[int, int], vp: VideoParams = VideoParams()):
    """The coarse-to-fine warm solve of one frame: ``warm_level_count``
    levels, ``vp.warm_iters_mid`` iterations on every non-finest level and
    ``vp.warm_iters_fine`` on the finest, re-warping every
    ``vp.warm_relin_every`` iterations (0 = ``mp.relin_every``).
    ``warm_solve(a, b, points, v_init, tc_v, tc_w)`` returns the field and
    its iteration count over all levels."""
    h, w = hw
    n = warm_level_count(hw, vp)
    shapes = pyramid_shapes(h, w, n)
    if vp.warm_relin_every:
        mp = dataclasses.replace(mp, relin_every=vp.warm_relin_every)
    solvers = [
        make_level_solver(mp, vp.warm_iters_fine if lv == 0 else vp.warm_iters_mid)
        for lv in range(n)
    ]

    def warm_solve(a, b, points, v_init, tc_v, tc_w):
        pyr_a, pyr_b, pyr_tcw = [a], [b], [tc_w]
        for _ in range(n - 1):
            pyr_a.append(downsample_2x(pyr_a[-1]))
            pyr_b.append(downsample_2x(pyr_b[-1]))
            pyr_tcw.append(downsample_2x(pyr_tcw[-1]))

        v = v_init
        iters_total = 0
        for lv in range(n - 1, -1, -1):
            lhw = shapes[lv]
            pts_l = scale_points(points, (h, w), lhw)
            ui_w_l, ui_v_l = rasterize_point_constraints(pts_l, lhw, mp.ui_sigma, a.dtype, a.device)
            tc_v_l = tc_v if lhw == (h, w) else resample_field(tc_v, lhw)
            v = v if tuple(v.shape[:2]) == lhw else resample_field(v, lhw)
            data_l = make_level_data(pyr_a[lv], pyr_b[lv], ui_w_l, ui_v_l, pyr_tcw[lv], tc_v_l)
            v, st = solvers[lv](v, data_l)
            iters_total += st.iters
        return v, iters_total

    return warm_solve


def warm_steps(clip_a: torch.Tensor, clip_b: torch.Tensor, fields: torch.Tensor, tracked: torch.Tensor,
               flows: dict, mp: MorphParams = MorphParams(), vp: VideoParams = VideoParams(), frames=None):
    """One step of the warm loop from given fields: for each frame t >= 1 in
    ``frames`` (default all), the warm solve of frame t started from
    ``fields[t - 1]`` advected by the flows, as the loop runs it. Returns
    the fields of those frames, (n, H, W, 2)."""
    h, w = clip_a.shape[1], clip_a.shape[2]
    warm_solve = _make_warm_solver(mp, (h, w), vp)
    idx = range(1, clip_a.shape[0]) if frames is None else frames
    out = fields.new_empty((len(idx),) + tuple(fields.shape[1:]))
    for k, t in enumerate(idx):
        if vp.propagate:
            tc_v, tc_w = advect_halfway_field(fields[t - 1], flows["fa_fwd"][t - 1], flows["fb_fwd"][t - 1], vp)
            v_init = tc_v
        else:
            tc_v, tc_w = torch.zeros_like(fields[t - 1]), fields.new_zeros((h, w, 1))
            v_init = torch.zeros_like(tc_v)
        out[k] = warm_solve(clip_a[t], clip_b[t], tracked[t], v_init, tc_v, tc_w)[0]
    return out


def _keyframes(points, dtype, device):
    """Points in keyframe form: (sorted frame indices, (K, N, 2, 2))."""
    if points is None:
        return [0], torch.zeros((1, 0, 2, 2), dtype=dtype, device=device)
    if isinstance(points, dict):
        key_idx = sorted(int(k) for k in points)
        return key_idx, torch.stack(
            [torch.as_tensor(points[k], dtype=dtype, device=device) for k in key_idx]
        )
    return [0], torch.as_tensor(points, dtype=dtype, device=device)[None]


def _clip_pair_flows(clip_a, clip_b, vp) -> dict:
    """Both clips' fwd/bwd flows."""
    fa_fwd, fa_bwd = clip_flows(clip_a, vp)
    fb_fwd, fb_bwd = clip_flows(clip_b, vp)
    return dict(fa_fwd=fa_fwd, fa_bwd=fa_bwd, fb_fwd=fb_fwd, fb_bwd=fb_bwd)


def flows_and_tracks(clip_a, clip_b, points, vp):
    """The clips' flows and the points tracked over the frames."""
    flows = _clip_pair_flows(clip_a, clip_b, vp)
    key_idx, key_pts = _keyframes(points, clip_a.dtype, clip_a.device)
    tracked = track_keyframe_points(
        clip_a.shape[0], key_idx, key_pts,
        flows["fa_fwd"], flows["fa_bwd"], flows["fb_fwd"], flows["fb_bwd"],
    )
    return flows, tracked


def _clip_confidences(fwd: torch.Tensor, bwd: torch.Tensor, t_len: int, vp: VideoParams) -> torch.Tensor:
    """Per-frame visibility confidence (t_len, H, W): frame t against frame
    t+1; the clip's last frame reuses the final pair's reverse direction."""
    conf = occlusion_confidence(fwd[:t_len], bwd[:t_len], vp)
    if conf.shape[0] < t_len:
        conf = torch.cat([conf, occlusion_confidence(bwd[-1], fwd[-1], vp)[None]], 0)
    return conf


def default_times(t_len: int, device) -> torch.Tensor:
    """``linspace(0, 1, T)`` in float32 as k * float32(1 / (T-1)), ending on 1.0."""
    if t_len == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    step = torch.arange(t_len - 1, dtype=torch.float32) * float(np.float32(1.0) / np.float32(t_len - 1))
    return torch.cat([step, torch.ones(1)]).to(device)


def render_frames(clip_a: torch.Tensor, clip_b: torch.Tensor, fields: torch.Tensor, flows: dict,
                  sp: SynthParams = SynthParams(), vp: VideoParams = VideoParams(), frames=None) -> torch.Tensor:
    """The clip's morph frames at the default times from ``fields``: each
    frame's bulge, its occlusion confidences from ``flows``, its render.
    ``frames``: the indices to render (default all); returns (n, H, W, C)."""
    t_len = clip_a.shape[0]
    times = np.asarray(default_times(t_len, "cpu"), np.float32)
    idx = range(t_len) if frames is None else frames
    if sp.occlusion_weighting and t_len > 1:
        conf_a = _clip_confidences(flows["fa_fwd"], flows["fa_bwd"], t_len, vp)
        conf_b = _clip_confidences(flows["fb_fwd"], flows["fb_bwd"], t_len, vp)
    else:
        conf_a = conf_b = clip_a.new_ones(clip_a.shape[:3])
    out = clip_a.new_empty((len(idx),) + tuple(clip_a.shape[1:]))
    for k, t in enumerate(idx):
        v = fields[t]
        b = bulge_field(v, sp) if sp.quadratic_paths else torch.zeros_like(v)
        out[k] = render_frame(clip_a[t], clip_b[t], v, b, times[t], sp, conf0=conf_a[t], conf1=conf_b[t])
    return out
