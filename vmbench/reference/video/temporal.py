"""Temporal propagation of the halfway field and point tracking [EGSR14 s3-4].

Port of ``videomorphing_tpu/video/temporal.py``. Given the converged field
v_{t-1}, its two endpoints are advected by the per-clip flows and re-formed
into a predicted field for frame t:

    x0 = p - v,   x1 = p + v
    x0' = x0 + flowA(x0),   x1' = x1 + flowB(x1)
    p'  = (x0' + x1')/2,    v'(p') = (x1' - x0')/2

The prediction warm-starts frame t and anchors its E_TC term. The main path
inverts the forward map by fixed-point iteration on gathers (kernel 4);
``bilinear_splat`` and ``advect_halfway_field_splat`` are the reference's
forward-splat oracle, kept as plain PyTorch for the tests only (their
scatter-add would need float atomics on the card, and nothing on the main
path calls them).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from vmbench.reference.config import VideoParams
from vmbench.reference.kernels import bilinear_sample, bilinear_sample_batched
from vmbench.reference.ops.poisson import pull_push_extend
from vmbench.reference.ops.pyramid import resize_bilinear
from vmbench.reference.ops.resample import grid_coords
from vmbench.reference.ops.resample import bilinear_sample as plain_sample
from vmbench.reference.solver.ctf import resample_field


def bilinear_splat(
    values: torch.Tensor, coords: torch.Tensor, hw: Tuple[int, int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter ``values`` (..., C) at float ``coords`` (..., 2) onto (H, W).

    Returns (accumulated (H, W, C), weight (H, W)); out-of-domain taps are
    dropped. Plain PyTorch, for the tests.
    """
    h, w = hw
    c = values.shape[-1]
    vals = values.reshape(-1, c)
    co = coords.reshape(-1, 2)
    y, x = co[:, 0], co[:, 1]
    y0, x0 = torch.floor(y), torch.floor(x)
    fy, fx = y - y0, x - x0
    y0i, x0i = y0.long(), x0.long()
    acc = values.new_zeros((h * w, c))
    wacc = values.new_zeros((h * w,))
    for dy, dx, wgt in (
        (0, 0, (1 - fy) * (1 - fx)),
        (0, 1, (1 - fy) * fx),
        (1, 0, fy * (1 - fx)),
        (1, 1, fy * fx),
    ):
        yy, xx = y0i + dy, x0i + dx
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = torch.where(ok, yy * w + xx, torch.zeros_like(yy))
        wv = torch.where(ok, wgt, torch.zeros_like(wgt))
        acc.index_add_(0, idx, vals * wv[:, None])
        wacc.index_add_(0, idx, wv)
    return acc.reshape(h, w, c), wacc.reshape(h, w)


def advect_halfway_field(
    v_prev: torch.Tensor,
    flow_a: torch.Tensor,
    flow_b: torch.Tensor,
    vp: VideoParams = VideoParams(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Predict (tc_v, tc_w) for frame t from frame t-1's converged field.

    ``flow_a``/``flow_b``: (H, W, 2) flows of clip A / clip B from frame t-1
    to t. Returns the propagated field (H, W, 2) and a confidence (H, W, 1)
    that drops to 0 where the fixed-point inversion of ``p' = p + s(p)``
    fails to contract (no preimage: the splat oracle's holes). With
    ``advect_scale < 1`` and frames of at least 128 px the inversion runs
    at reduced resolution, its residual threshold converted to that
    resolution's pixels. Six samples per call, all through kernel 4 (the
    two endpoint flows in one batched launch).
    """
    h, w = v_prev.shape[0], v_prev.shape[1]
    if vp.advect_scale < 1.0 and min(h, w) >= 128:
        hh = max(int(round(h * vp.advect_scale)), 1)
        ww = max(int(round(w * vp.advect_scale)), 1)
        vp_full = dataclasses.replace(
            vp, advect_scale=1.0, advect_residual=vp.advect_residual * (hh / h)
        )
        tc_h, conf_h = advect_halfway_field(
            resample_field(v_prev, (hh, ww)),
            resample_field(flow_a, (hh, ww)),
            resample_field(flow_b, (hh, ww)),
            vp_full,
        )
        return resample_field(tc_h, (h, w)), resize_bilinear(conf_h, (h, w))

    g = grid_coords(h, w, dtype=v_prev.dtype, device=v_prev.device)
    x0 = g - v_prev
    x1 = g + v_prev
    fa, fb = bilinear_sample_batched(torch.stack([flow_a, flow_b]), torch.stack([x0, x1]))
    shift = 0.5 * (fa + fb)            # s(p) = p' - p
    u = v_prev + 0.5 * (fb - fa)       # v'(p') as a function of p

    p = g - shift
    delta = v_prev.new_zeros((h, w))
    for _ in range(max(int(vp.advect_invert_iters), 1)):
        p_new = g - bilinear_sample(shift, p)
        delta = torch.linalg.vector_norm(p_new - p, dim=-1)
        p = p_new
    tc_v = bilinear_sample(u, p)

    inside = (
        (p[..., 0] >= 0.0) & (p[..., 0] <= h - 1.0)
        & (p[..., 1] >= 0.0) & (p[..., 1] <= w - 1.0)
    )
    conf = torch.clamp(1.0 - delta / vp.advect_residual, 0.0, 1.0) * inside
    return tc_v, conf[..., None].to(v_prev.dtype)


def advect_halfway_field_splat(
    v_prev: torch.Tensor,
    flow_a: torch.Tensor,
    flow_b: torch.Tensor,
    vp: VideoParams = VideoParams(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward-splat oracle for :func:`advect_halfway_field` (plain PyTorch,
    for the tests)."""
    h, w = v_prev.shape[0], v_prev.shape[1]
    g = grid_coords(h, w, dtype=v_prev.dtype, device=v_prev.device)
    x0 = g - v_prev
    x1 = g + v_prev
    x0n = x0 + plain_sample(flow_a, x0)
    x1n = x1 + plain_sample(flow_b, x1)
    acc, wgt = bilinear_splat(0.5 * (x1n - x0n), 0.5 * (x0n + x1n), (h, w))
    filled = pull_push_extend(
        acc / torch.clamp(wgt, min=1e-6)[..., None], torch.clamp(wgt, 0.0, 1.0)
    )
    conf = torch.clamp(wgt, 0.0, 1.0) * (wgt > vp.tc_fill_thresh)
    return filled, conf[..., None].to(v_prev.dtype)


def track_points(points: torch.Tensor, flow_a: torch.Tensor, flow_b: torch.Tensor) -> torch.Tensor:
    """Advance UI point pairs (N, 2, 2) one frame: q0 follows clip A's flow,
    q1 clip B's, each sampled at the point through kernel 4."""
    if points.shape[0] == 0:
        return points
    q0 = points[:, 0]
    q1 = points[:, 1]
    return torch.stack([q0 + bilinear_sample(flow_a, q0), q1 + bilinear_sample(flow_b, q1)], 1)


def track_keyframe_points(
    t_len: int,
    key_idx: Sequence[int],
    key_pts: torch.Tensor,
    fa_fwd: torch.Tensor,
    fa_bwd: torch.Tensor,
    fb_fwd: torch.Tensor,
    fb_bwd: torch.Tensor,
) -> torch.Tensor:
    """Track UI point pairs from KEYFRAMES to every frame [EGSR14 s3].

    ``key_idx``: sorted frame indices of the K keyframes; ``key_pts``
    (K, N, 2, 2) the user's pairs there (the same N identities on each).
    Frames after the first keyframe track forward from the latest keyframe
    and re-anchor at each keyframe; frames before it track backward with
    the reverse flows. Returns (T, N, 2, 2).
    """
    key_idx = [int(k) for k in key_idx]
    n = key_pts.shape[1]
    if n == 0 or t_len == 1:
        return key_pts[:1].expand(t_len, n, 2, 2).clone()
    at = {idx: key_pts[k] for k, idx in enumerate(key_idx)}
    first = key_idx[0]
    tracked = [None] * t_len
    cur = tracked[first] = at[first]
    for t in range(first + 1, t_len):
        cand = track_points(cur, fa_fwd[t - 1], fb_fwd[t - 1])
        cur = tracked[t] = at.get(t, cand)
    cur = at[first]
    for t in range(first - 1, -1, -1):
        # bwd[t] maps frame t+1 back to t, sampled at t+1
        cur = tracked[t] = track_points(cur, fa_bwd[t], fb_bwd[t])
    return torch.stack(tracked)
