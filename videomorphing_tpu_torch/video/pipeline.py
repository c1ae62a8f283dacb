"""The video morphing pipeline: flows once, frame 0 cold, then a warm loop
over frames carrying the converged field [EGSR14].

Port of ``videomorphing_tpu/video/pipeline.py``. Frame 0 solves the full
coarse-to-fine pyramid. Every later frame is warm-started from the
temporally advected field and solves only the warm levels (one at up to
2.4 Mpx) with few iterations. The reference's ``lax.scan`` over frames is a
Python loop here that keeps each frame's state on the device; its
``lax.map``s over frames (bulges, render) are loops that write into one
preallocated output, so peak memory holds one frame's intermediates.

Stages, each a ``utils.profiling.phase_scope``: ``flows``, ``tracking``,
``cold_solve``, ``warm_loop`` (the loop's per-frame iteration counts are
noted as ``warm_iters``), ``bulges``, ``confidences`` and ``render``. Each
frame of the render is a ``render.frame`` span.

With a 1-D ``mesh`` (``parallel.mesh.Mesh``) of more than one device the
flows split their frame pairs over it (``flow.clip_flows_sharded``), the
solve runs one frame block per device (``parallel.video_blocks``; a clip
that does not divide pads with repeats of its last frame and is trimmed)
and the render splits its frames (``parallel.frames``), as the
reference's.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from videomorphing_tpu_torch.config import MorphParams, SynthParams, VideoParams
from videomorphing_tpu_torch.ops.pyramid import downsample_2x, pyramid_shapes
from videomorphing_tpu_torch.solver.constraints import rasterize_point_constraints, scale_points
from videomorphing_tpu_torch.solver.ctf import optimize_pair, resample_field
from videomorphing_tpu_torch.solver.descent import make_level_solver
from videomorphing_tpu_torch.solver.energy import make_level_data
from videomorphing_tpu_torch.synth.paths import bulge_field
from videomorphing_tpu_torch.synth.render import render_frame
from videomorphing_tpu_torch.utils.profiling import note, phase_scope, span
from videomorphing_tpu_torch.video.flow import clip_flows, clip_flows_sharded
from videomorphing_tpu_torch.video.occlusion import occlusion_confidence
from videomorphing_tpu_torch.video.temporal import advect_halfway_field, track_keyframe_points


class VideoResult(NamedTuple):
    fields: torch.Tensor                      # (T, H, W, 2) converged halfway fields
    bulges: Optional[torch.Tensor]            # (T, H, W, 2) quadratic-path bulges
    frames: Optional[torch.Tensor]            # (T, H, W, C) rendered morph frames
    tracked_points: Optional[torch.Tensor]    # (T, N, 2, 2) tracked UI pairs
    solve_iters: Optional[int] = None         # optimizer iterations, cold + warm


def _mesh_size(mesh, axis: str) -> int:
    """Devices on ``axis`` of ``mesh`` (1 without a mesh)."""
    if mesh is None:
        return 1
    from videomorphing_tpu_torch.parallel.mesh import as_mesh

    return int(as_mesh(mesh).shape[axis])


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


def _frame_scan(mp: MorphParams, vp: VideoParams, hw: Tuple[int, int]):
    """The warm-started loop over frames (the reference's jitted scan):
    ``run(clip_a_rest, clip_b_rest, v0, ptss_rest, fa_fwd, fb_fwd)`` ->
    ``(fields (n, H, W, 2), iterations per frame)``, where frame k is
    advected from frame k-1's field (``v0`` before the first) by flows k."""
    h, w = hw
    warm_solve = _make_warm_solver(mp, hw, vp)

    def run(clip_a_rest, clip_b_rest, v0, ptss_rest, fa_fwd, fb_fwd):
        vs = v0.new_empty((clip_a_rest.shape[0],) + tuple(v0.shape))
        iters: List[int] = []
        v_prev = v0
        for t in range(clip_a_rest.shape[0]):
            if vp.propagate:
                tc_v, tc_w = advect_halfway_field(v_prev, fa_fwd[t], fb_fwd[t], vp)
                v_init = tc_v
            else:
                tc_v = torch.zeros_like(v_prev)
                tc_w = v_prev.new_zeros((h, w, 1))
                v_init = torch.zeros_like(v_prev)
            v_prev, n_iters = warm_solve(clip_a_rest[t], clip_b_rest[t], ptss_rest[t], v_init, tc_v, tc_w)
            vs[t] = v_prev
            iters.append(n_iters)
        return vs, iters

    return run


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


def _clip_pair_flows(clip_a, clip_b, vp, mesh=None, mesh_axis: str = "batch") -> dict:
    """Both clips' fwd/bwd flows, their frame pairs split over a mesh of
    more than one device (and more than one pair)."""
    with phase_scope("flows"):
        if _mesh_size(mesh, mesh_axis) > 1 and clip_a.shape[0] > 2:
            fa_fwd, fa_bwd = clip_flows_sharded(clip_a, vp, mesh, mesh_axis)
            fb_fwd, fb_bwd = clip_flows_sharded(clip_b, vp, mesh, mesh_axis)
        else:
            fa_fwd, fa_bwd = clip_flows(clip_a, vp)
            fb_fwd, fb_bwd = clip_flows(clip_b, vp)
    return dict(fa_fwd=fa_fwd, fa_bwd=fa_bwd, fb_fwd=fb_fwd, fb_bwd=fb_bwd)


def _flows_and_tracks(clip_a, clip_b, points, vp, mesh=None, mesh_axis: str = "batch"):
    flows = _clip_pair_flows(clip_a, clip_b, vp, mesh, mesh_axis)
    with phase_scope("tracking"):
        key_idx, key_pts = _keyframes(points, clip_a.dtype, clip_a.device)
        tracked = track_keyframe_points(
            clip_a.shape[0], key_idx, key_pts,
            flows["fa_fwd"], flows["fa_bwd"], flows["fb_fwd"], flows["fb_bwd"],
        )
    return flows, tracked


def solve_clip_fields(
    clip_a: torch.Tensor,
    clip_b: torch.Tensor,
    points=None,
    mp: MorphParams = MorphParams(),
    vp: VideoParams = VideoParams(),
    mesh=None,
    mesh_axis: str = "batch",
    return_stats: bool = False,
):
    """Solve halfway fields for every frame pair of two clips (T, H, W, C).

    ``points``: None, one (N, 2, 2) set on frame 0 (tracked forward), or a
    keyframe mapping ``{frame_idx: (N, 2, 2)}`` with the same N identities
    on every keyframe. Returns ``(fields (T, H, W, 2), tracked (T, N, 2,
    2), flows)`` with ``flows`` the dict of per-clip fwd/bwd flows, plus the
    total optimizer iterations when ``return_stats`` (on the blocked path
    every block's cold head and warm frames, padded repeats included).
    """
    t_len, h, w = clip_a.shape[0], clip_a.shape[1], clip_a.shape[2]
    n_dev = _mesh_size(mesh, mesh_axis)
    flows, tracked = _flows_and_tracks(clip_a, clip_b, points, vp, mesh, mesh_axis)

    if n_dev > 1 and t_len > 1:
        from videomorphing_tpu_torch.parallel.frames import pad_to_multiple
        from videomorphing_tpu_torch.parallel.video_blocks import solve_clip_fields_blocked

        # repeats of the last frame, with zero flow between them
        pad = (-t_len) % n_dev
        pad_frames = lambda x: pad_to_multiple(x, n_dev)[0]

        def pad_flows(f):
            return torch.cat([f, f.new_zeros((pad,) + tuple(f.shape[1:]))], 0) if pad else f

        fields, iters = solve_clip_fields_blocked(
            pad_frames(clip_a), pad_frames(clip_b), pad_frames(tracked),
            {k: pad_flows(f) for k, f in flows.items()}, mesh, mp, vp, mesh_axis,
        )
        fields = fields[:t_len]
        if return_stats:
            return fields, tracked, flows, iters
        return fields, tracked, flows

    with phase_scope("cold_solve"):
        res0 = optimize_pair(clip_a[0], clip_b[0], points=tracked[0], params=mp)
    v0 = res0.v
    iters = sum(s.iters for s in res0.level_stats)
    fields = v0[None]
    if t_len > 1:
        with phase_scope("warm_loop"):
            vs, warm_iters = _frame_scan(mp, vp, (h, w))(
                clip_a[1:], clip_b[1:], v0, tracked[1:], flows["fa_fwd"], flows["fb_fwd"]
            )
            fields = torch.cat([v0[None], vs], 0)
        note("warm_iters", warm_iters)
        iters += sum(warm_iters)
    if return_stats:
        return fields, tracked, flows, iters
    return fields, tracked, flows


def _clip_confidences(fwd: torch.Tensor, bwd: torch.Tensor, t_len: int, vp: VideoParams) -> torch.Tensor:
    """Per-frame visibility confidence (t_len, H, W) of the frames that the
    pairs ``fwd``/``bwd`` start from: frame t against frame t+1 (one
    batched round trip over the pairs); when the pairs run out (t_len =
    pairs + 1, a clip's last frame) that frame reuses the final pair's
    reverse direction."""
    conf = occlusion_confidence(fwd[:t_len], bwd[:t_len], vp)
    if conf.shape[0] < t_len:
        conf = torch.cat([conf, occlusion_confidence(bwd[-1], fwd[-1], vp)[None]], 0)
    return conf


def clip_bulges(fields: torch.Tensor, sp: SynthParams) -> torch.Tensor:
    """The bulge of every frame's field (T, H, W, 2), one frame at a time
    into one preallocated output."""
    bulges = torch.empty_like(fields)
    for t in range(fields.shape[0]):
        bulges[t] = bulge_field(fields[t], sp)
    return bulges


def _default_times(t_len: int, device) -> torch.Tensor:
    """The reference's ``jnp.linspace(0, 1, T, dtype=float32)`` bit for bit:
    XLA computes k / (T-1) as k * float32(1 / (T-1)), and ends on an exact
    1.0."""
    if t_len == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    step = torch.arange(t_len - 1, dtype=torch.float32) * float(np.float32(1.0) / np.float32(t_len - 1))
    return torch.cat([step, torch.ones(1)]).to(device)


def render_video(
    clip_a: torch.Tensor,
    clip_b: torch.Tensor,
    fields: torch.Tensor,
    times=None,
    sp: SynthParams = SynthParams(),
    vp: VideoParams = VideoParams(),
    bulges: Optional[torch.Tensor] = None,
    flows: Optional[dict] = None,
    render: bool = True,
    mesh=None,
    mesh_axis: str = "batch",
) -> VideoResult:
    """Synthesis half of the pipeline: paths and the occlusion-aware render.

    ``flows`` (from :func:`solve_clip_fields`) are recomputed when absent
    and occlusion weighting is on. ``times``: per-frame morph time
    (default: a linear 0 -> 1 transition across the clip). With a ``mesh``
    each of its devices runs :func:`synthesize_frames` on its share of the
    frames (``parallel.frames.render_video_frames_sharded``).
    """
    t_len = clip_a.shape[0]
    if render:
        if times is None:
            times = _default_times(t_len, clip_a.device)
        times = np.asarray(torch.as_tensor(times).detach().cpu(), np.float32).reshape(-1)
    need_occl = render and sp.occlusion_weighting and t_len > 1
    if need_occl and flows is None:
        flows = _clip_pair_flows(clip_a, clip_b, vp, mesh, mesh_axis)
    occl_flows = flows if need_occl else None
    if render and _mesh_size(mesh, mesh_axis) > 1 and t_len > 1:
        from videomorphing_tpu_torch.parallel.frames import render_video_frames_sharded

        bulges, frames = render_video_frames_sharded(
            clip_a, clip_b, fields, times, mesh, sp, vp, mesh_axis, bulges=bulges, flows=occl_flows
        )
    else:
        bulges, frames = synthesize_frames(clip_a, clip_b, fields, times, sp, vp, bulges, occl_flows, render)
    return VideoResult(fields=fields, bulges=bulges, frames=frames, tracked_points=None)


def synthesize_frames(
    clip_a: torch.Tensor,
    clip_b: torch.Tensor,
    fields: torch.Tensor,
    times,
    sp: SynthParams,
    vp: VideoParams,
    bulges: Optional[torch.Tensor] = None,
    flows: Optional[dict] = None,
    render: bool = True,
    share: slice = slice(None),
    device=None,
    conf_flows: Optional[tuple] = None,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The synthesis of the clip's frames ``share`` on ``device`` (default:
    all frames, on the clip's device): their bulges (as given, else computed
    when ``sp.quadratic_paths``), their occlusion confidences from the
    clip's ``flows`` or from the per-frame flow stacks ``conf_flows``
    ``(af, ab, bf, bb)`` (frame t's from ``(af[t], ab[t])`` and ``(bf[t],
    bb[t])``; with neither, no occlusion weighting) and, when ``render``,
    the frames at ``times`` (numpy, one per clip frame). Returns
    ``(bulges, frames)`` of the share, on ``device``."""
    t_len = clip_a.shape[0]
    s, e, _ = share.indices(t_len)
    dev = clip_a.device if device is None else torch.device(device)
    put = lambda x: x[s:e].to(dev)
    a, b, v = put(clip_a), put(clip_b), put(fields)
    if bulges is not None:
        bulges = put(bulges)
    elif sp.quadratic_paths:
        with phase_scope("bulges"):
            bulges = clip_bulges(v, sp)
    if not render:
        return bulges, None
    with phase_scope("confidences"):
        if conf_flows is not None:
            af, ab, bf, bb = (put(x) for x in conf_flows)
            conf_a = occlusion_confidence(af, ab, vp)
            conf_b = occlusion_confidence(bf, bb, vp)
        elif flows is not None:
            lo = min(s, t_len - 2)  # the clip's last frame reads the final pair
            f = {k: x[lo:e].to(dev) for k, x in flows.items()}
            conf_a = _clip_confidences(f["fa_fwd"], f["fa_bwd"], e - lo, vp)[s - lo:]
            conf_b = _clip_confidences(f["fb_fwd"], f["fb_bwd"], e - lo, vp)[s - lo:]
        else:
            conf_a = conf_b = a.new_ones(a.shape[:3])
    with phase_scope("render"):
        bl = bulges if bulges is not None else torch.zeros_like(v)
        frames = torch.empty_like(a)
        for t in range(e - s):
            with span("render.frame"):
                frames[t] = render_frame(
                    a[t], b[t], v[t], bl[t], times[s + t], sp, conf0=conf_a[t], conf1=conf_b[t],
                )
    return bulges, frames


def morph_video(
    clip_a: torch.Tensor,
    clip_b: torch.Tensor,
    points=None,
    times=None,
    mp: MorphParams = MorphParams(),
    sp: SynthParams = SynthParams(),
    vp: VideoParams = VideoParams(),
    render: bool = True,
    mesh=None,
) -> VideoResult:
    """Full video morph: solve fields, bend paths, render the transition;
    a 1-D ``mesh`` spreads the flows, frame blocks and render over its
    devices."""
    fields, tracked, flows, iters = solve_clip_fields(
        clip_a, clip_b, points, mp, vp, mesh=mesh, return_stats=True
    )
    res = render_video(
        clip_a, clip_b, fields, times=times, sp=sp, vp=vp, flows=flows, render=render, mesh=mesh
    )
    return res._replace(tracked_points=tracked, solve_iters=iters)


def resume_clip_fields(
    clip_a: torch.Tensor,
    clip_b: torch.Tensor,
    v_prev: torch.Tensor,
    start: int,
    points=None,
    mp: MorphParams = MorphParams(),
    vp: VideoParams = VideoParams(),
) -> torch.Tensor:
    """Continue a partially solved clip from frame ``start``: ``v_prev`` is
    the converged field of frame ``start - 1``. Returns the fields of frames
    [start, T), the same warm loop the full solve runs, entered mid-clip."""
    t_len, h, w = clip_a.shape[0], clip_a.shape[1], clip_a.shape[2]
    if not 1 <= start < t_len:
        raise ValueError(f"start must be in [1, {t_len}), got {start}")
    flows, tracked = _flows_and_tracks(clip_a, clip_b, points, vp)
    v_prev = torch.as_tensor(v_prev, dtype=clip_a.dtype, device=clip_a.device)
    vs, _iters = _frame_scan(mp, vp, (h, w))(
        clip_a[start:], clip_b[start:], v_prev, tracked[start:],
        flows["fa_fwd"][start - 1:], flows["fb_fwd"][start - 1:],
    )
    return vs
