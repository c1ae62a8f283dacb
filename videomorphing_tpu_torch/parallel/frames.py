"""Frames and pairs split over the devices of a mesh (port of
``videomorphing_tpu/parallel/frames.py``).

Synthesis is independent across output times, and pair solves across
pairs. Each device of the mesh's axis takes one contiguous share; the items
pad to a multiple of the axis size by repeating the last one, as the
reference's ``_pad_to_multiple`` does, and the padded results are trimmed
(the video render needs no padding: its shares are slices of the clip).
The shares run one after another from this process; the results gather on
the inputs' device.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from videomorphing_tpu_torch.config import MorphParams, SynthParams, VideoParams
from videomorphing_tpu_torch.parallel.mesh import as_mesh
from videomorphing_tpu_torch.synth.render import render_clip


def pad_to_multiple(x: torch.Tensor, m: int) -> Tuple[torch.Tensor, int]:
    """``x`` padded along dim 0 to a multiple of ``m`` by repeating its
    last item, and its original length."""
    n = x.shape[0]
    pad = (-n) % m
    if pad == 0:
        return x, n
    return torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))], 0), n


def shares(n: int, n_dev: int) -> List[slice]:
    """The contiguous share of each of ``n_dev`` devices in ``n`` items:
    ceil(n / n_dev) each, the last ones shorter or empty when ``n_dev``
    does not divide ``n``."""
    per = -(-n // n_dev)
    return [slice(min(k * per, n), min((k + 1) * per, n)) for k in range(n_dev)]


def render_clip_sharded(
    i0: torch.Tensor,
    i1: torch.Tensor,
    v: torch.Tensor,
    b: Optional[torch.Tensor],
    ts,
    mesh,
    sp: SynthParams = SynthParams(),
    axis: str = "batch",
) -> torch.Tensor:
    """Frames at times ``ts`` (K,) split over the mesh's devices; the pair
    and its field are replicated. Returns (K, H, W, C) on ``i0``'s device."""
    devs = as_mesh(mesh).axis_devices(axis)
    ts = torch.as_tensor(np.asarray(ts.detach().cpu() if isinstance(ts, torch.Tensor) else ts, np.float32))
    ts_p, n = pad_to_multiple(ts.reshape(-1), len(devs))
    out = []
    for dev, sl in zip(devs, shares(ts_p.shape[0], len(devs))):
        put = lambda x: None if x is None else x.to(dev)
        out.append(render_clip(put(i0), put(i1), put(v), put(b), ts_p[sl], sp).to(i0.device))
    return torch.cat(out, 0)[:n]


def render_video_frames_sharded(
    clip_a: torch.Tensor,
    clip_b: torch.Tensor,
    fields: torch.Tensor,
    times,
    mesh,
    sp: SynthParams = SynthParams(),
    vp: VideoParams = VideoParams(),
    axis: str = "batch",
    bulges: Optional[torch.Tensor] = None,
    conf_flows: Optional[tuple] = None,
    flows: Optional[dict] = None,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Video synthesis split over the mesh by frames: frame t needs only
    (A_t, B_t, v_t, t_t) and its flows, so each device runs the sequential
    synthesis (``video.pipeline.synthesize_frames``: bulges unless given,
    occlusion confidences, the render) on its contiguous share of the
    frames; no padding is needed. The confidences come, as the
    reference's, from ``conf_flows``, a tuple of four (T, H, W, 2)
    per-frame flow stacks ``(af, ab, bf, bb)`` (frame t's from ``(af[t],
    ab[t])`` and ``(bf[t], bb[t])``), or from the clip's ``flows`` dict of
    ``video.pipeline.solve_clip_fields`` (the port's own route); with
    neither, every confidence is 1. Returns ``(bulges, frames)`` on
    ``clip_a``'s device (``bulges`` None when neither given nor
    computed)."""
    from videomorphing_tpu_torch.video.pipeline import synthesize_frames

    if conf_flows is not None and flows is not None:
        raise ValueError("render_video_frames_sharded takes conf_flows or flows, not both")
    devs = as_mesh(mesh).axis_devices(axis)
    times = np.asarray(torch.as_tensor(times).detach().cpu(), np.float32).reshape(-1)
    home = clip_a.device
    outs = [
        synthesize_frames(clip_a, clip_b, fields, times, sp, vp, bulges, flows, share=sl, device=dev,
                          conf_flows=conf_flows)
        for dev, sl in zip(devs, shares(clip_a.shape[0], len(devs)))
        if sl.stop > sl.start
    ]
    frames = torch.cat([fr.to(home) for _bl, fr in outs], 0)
    if outs[0][0] is None:
        return None, frames
    return torch.cat([bl.to(home) for bl, _fr in outs], 0), frames


def optimize_pairs_batched(
    i0s: torch.Tensor,
    i1s: torch.Tensor,
    mesh,
    params: MorphParams = MorphParams(),
    points: Optional[torch.Tensor] = None,
    axis: str = "batch",
    results: Optional[list] = None,
) -> torch.Tensor:
    """Coarse-to-fine solves of a batch of pairs (B, H, W, C), B split over
    the mesh by :func:`shares`: each device solves its pairs one after
    another. B need not divide over the devices (the reference's sharded
    jit needs that; a short block leaves the last devices idle here).
    Returns (B, H, W, 2) fields on ``i0s``' device.

    ``results``: optional list; each pair's ``solver.ctf.OptimizeResult``
    (``v`` on its device of the mesh, ``level_stats``, ``n_levels``) is
    appended to it in the block's order, as ``optimize_pair`` returned it.
    The fields returned are copies of those ``v``, bit for bit."""
    from videomorphing_tpu_torch.solver.ctf import optimize_pair

    devs = as_mesh(mesh).axis_devices(axis)
    bsz = i0s.shape[0]
    out = []
    for dev, sl in zip(devs, shares(bsz, len(devs))):
        for j in range(sl.start, sl.stop):
            pts = None if points is None else points[j].to(dev)
            res = optimize_pair(i0s[j].to(dev), i1s[j].to(dev), points=pts, params=params)
            out.append(res.v.to(i0s.device))
            if results is not None:
                results.append(res)
    return torch.stack(out, 0)
