"""Frame rendering: invert the motion path, warp both sources, blend.

Port of ``videomorphing_tpu/synth/render.py``. Each output pixel q finds its
halfway point p with x_t(p) = q by a short fixed-point iteration (coarse to
fine), then both sources are sampled backward at p -/+ v(p) and blended.

Every bilinear sample here goes through kernel 4 (``kernels.warp.
bilinear_sample`` and its batched form), which launches the CUDA sampler
for tensors on the card and runs its plain version on the CPU. The
reference's ``SynthParams.fused_sampling`` and its TPU-only dispatch are
ignored: both paths compute the same numbers. ``sampling="bicubic"`` stays
plain PyTorch, as in the reference, which has no bicubic kernel.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from videomorphing_tpu_torch.config import SynthParams
from videomorphing_tpu_torch.kernels.warp import bilinear_sample, bilinear_sample_batched
from videomorphing_tpu_torch.ops.pyramid import downsample_2x, resize_bilinear
from videomorphing_tpu_torch.ops.resample import bicubic_sample, grid_coords, inside_mask
from videomorphing_tpu_torch.synth.blend import blend_extended
from videomorphing_tpu_torch.utils import profiling

f32 = np.float32


def path_displacement(v: torch.Tensor, b: Optional[torch.Tensor], t) -> torch.Tensor:
    """Displacement field d_t(p) = x_t(p) - p = (2t-1) v + 4t(1-t) b, with
    the coefficients rounded to float32 step by step as the reference's
    float32 ``t`` rounds them."""
    t = f32(t)
    d = float(f32(2.0) * t - f32(1.0)) * v
    if b is not None:
        d = d + float(f32(4.0) * t * (f32(1.0) - t)) * b
    return d


def _coarse_fixed_point(disp_c: torch.Tensor, qc: torch.Tensor, n: int, p0=None) -> torch.Tensor:
    """``n`` fixed-point iterations ``p <- q - disp(p)`` at coarse resolution."""
    p = qc if p0 is None else p0
    for _ in range(n):
        p = qc - bilinear_sample(disp_c, p)
    return p


def _multiscale_start(disp: torch.Tensor, h: int, w: int, n_iters: int) -> torch.Tensor:
    """Coarse-to-fine fixed-point start: the full-resolution estimate of p.

    Quarter resolution runs all but two of the iterations when the frame
    is at least 256 px on its short side, half resolution polishes once;
    otherwise half resolution runs all but one.
    """
    dtype, dev = disp.dtype, disp.device
    hh, ww = -(-h // 2), -(-w // 2)
    disp_h = downsample_2x(disp) * 0.5
    qh = grid_coords(hh, ww, dtype=dtype, device=dev)
    if min(h, w) >= 256 and n_iters > 2:
        hq, wq = -(-hh // 2), -(-ww // 2)
        disp_q = downsample_2x(disp_h) * 0.5
        qq = grid_coords(hq, wq, dtype=dtype, device=dev)
        pq = _coarse_fixed_point(disp_q, qq, n_iters - 2)
        corr_q = resize_bilinear(pq - qq, (hh, ww))
        ph = _coarse_fixed_point(disp_h, qh, 1, p0=qh + corr_q * 2.0)
    else:
        ph = _coarse_fixed_point(disp_h, qh, n_iters - 1)
    q = grid_coords(h, w, dtype=dtype, device=dev)
    corr = resize_bilinear(ph - qh, (h, w))
    return q + corr * 2.0


def invert_path(
    v: torch.Tensor,
    b: Optional[torch.Tensor],
    t,
    n_iters: int = 6,
    multiscale: bool = True,
    use_fused: Optional[bool] = None,
) -> torch.Tensor:
    """Halfway coordinates p(q) (H, W, 2) with x_t(p) = q for every output q.

    ``use_fused`` is the reference's TPU dispatch knob, accepted and
    ignored (as ``SynthParams.fused_sampling``): the samples run kernel 4
    whenever the field lies on the card, and the result does not depend on
    it."""
    h, w = v.shape[0], v.shape[1]
    q = grid_coords(h, w, dtype=v.dtype, device=v.device)
    disp = path_displacement(v, b, t)
    if multiscale and min(h, w) >= 128 and n_iters > 1:
        p = _multiscale_start(disp, h, w, n_iters)
        return q - bilinear_sample(disp, p)
    return _coarse_fixed_point(disp, q, n_iters)


def invert_path_with_field(
    v: torch.Tensor,
    b: Optional[torch.Tensor],
    t,
    n_iters: int = 6,
    multiscale: bool = True,
    use_fused: Optional[bool] = None,
):
    """:func:`invert_path` that also returns ``v(p)``: the last sample reads
    the stacked planes ``[d_t, v]`` in one 4-channel gather, with ``v`` at
    the penultimate iterate. Returns ``(p, v_at_p)``. ``use_fused`` is
    accepted and ignored, as in :func:`invert_path`."""
    h, w = v.shape[0], v.shape[1]
    q = grid_coords(h, w, dtype=v.dtype, device=v.device)
    disp = path_displacement(v, b, t)
    stacked = torch.cat([disp, v], dim=-1)
    if multiscale and min(h, w) >= 128 and n_iters > 1:
        p = _multiscale_start(disp, h, w, n_iters)
    else:
        p = _coarse_fixed_point(disp, q, max(n_iters - 1, 0))
    s = bilinear_sample(stacked, p)
    return q - s[..., :2], s[..., 2:].contiguous()


class FrameAux(NamedTuple):
    mask0: torch.Tensor         # (H, W) validity of the I0 sample
    mask1: torch.Tensor         # (H, W) validity of the I1 sample
    inv_residual: torch.Tensor  # (H, W) |x_t(p(q)) - q|, the path inversion's error


def render_frame(
    i0: torch.Tensor,
    i1: torch.Tensor,
    v: torch.Tensor,
    b: Optional[torch.Tensor],
    t,
    sp: SynthParams = SynthParams(),
    conf0: Optional[torch.Tensor] = None,
    conf1: Optional[torch.Tensor] = None,
    with_aux: bool = False,
    srcs0=None,
    srcs1=None,
):
    """Synthesize the morph frame at time ``t`` in [0, 1]:
    c_t(q) = (1-t) I0(phi0(p(q))) + t I1(phi1(p(q))), Poisson-extended and,
    with the per-source visibility maps ``conf0``/``conf1`` (H, W) of the
    video pipeline, occlusion-aware.

    Each confidence rides along as a 4th image channel through the colour
    samples and is clipped to [0, 1] after sampling (the bicubic
    interpolant can overshoot). The two bilinear colour samples are one
    launch of the batched sampler. ``with_aux`` also returns a
    :class:`FrameAux`: ``(frame, aux)``.

    ``srcs0``/``srcs1`` are the reference's prebuilt TPU sampler sources
    (copies of ``i0``/``i1`` laid out for its Pallas gather); they are
    accepted and ignored: the port samples ``i0``/``i1`` themselves, and the
    frame does not depend on them.
    """
    h, w = i0.shape[0], i0.shape[1]
    t = f32(t)
    p, v_at_p = invert_path_with_field(v, b, t, sp.invert_iters, multiscale=sp.invert_multiscale)
    phi0 = p - v_at_p
    phi1 = p + v_at_p
    with_conf = conf0 is not None and conf1 is not None
    if with_conf:
        i0 = torch.cat([i0, conf0[..., None]], -1)
        i1 = torch.cat([i1, conf1[..., None]], -1)
    if sp.sampling == "bicubic":
        s0, s1 = bicubic_sample(i0, phi0), bicubic_sample(i1, phi1)
    else:
        s0, s1 = bilinear_sample_batched(torch.stack([i0, i1]), torch.stack([phi0, phi1]))
    c0 = c1 = None
    if with_conf:
        s0, c0 = s0[..., :-1], torch.clamp(s0[..., -1], 0.0, 1.0)
        s1, c1 = s1[..., :-1], torch.clamp(s1[..., -1], 0.0, 1.0)
    m0 = inside_mask(phi0, h, w)
    m1 = inside_mask(phi1, h, w)
    out = blend_extended(s0, s1, m0, m1, float(t), sp, c0, c1)
    if not with_aux:
        return out
    disp = path_displacement(v, b, t)
    q = grid_coords(h, w, dtype=v.dtype, device=v.device)
    res = torch.linalg.norm(p + bilinear_sample(disp, p) - q, dim=-1)
    return out, FrameAux(mask0=m0, mask1=m1, inv_residual=res)


def render_clip(
    i0: torch.Tensor,
    i1: torch.Tensor,
    v: torch.Tensor,
    b: Optional[torch.Tensor],
    ts: Sequence[float],
    sp: SynthParams = SynthParams(),
) -> torch.Tensor:
    """One frame per time in ``ts`` (K,) -> (K, H, W, C); traced, each
    frame is a ``render.frame`` span."""
    ts = np.asarray(ts.detach().cpu() if isinstance(ts, torch.Tensor) else ts, np.float32)
    frames = []
    for t in ts.reshape(-1):
        with profiling.span("render.frame"):
            frames.append(render_frame(i0, i1, v, b, t, sp))
    return torch.stack(frames)


@functools.lru_cache(maxsize=None)
def jitted_render_clip(sp: SynthParams):
    """:func:`render_clip` bound to ``sp``, cached per ``SynthParams``: the
    reference's jitted callable, here the plain function (PyTorch runs
    eagerly)."""
    return lambda i0, i1, v, b, ts: render_clip(i0, i1, v, b, ts, sp)
