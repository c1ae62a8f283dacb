"""Pyramid Horn-Schunck optical flow (and its robust Brox-class variant).

Port of ``videomorphing_tpu/video/flow.py``. Per-clip flow t -> t+1 and its
reverse warm-start and regularize the halfway solve, track the UI points and
drive occlusion detection.

Layouts: a grey image is (H, W), a colour image (H, W, C), a flow (H, W, 2)
in (dy, dx), with b(p + u(p)) ~ a(p). Every stencil here also takes a
trailing batch axis, grey (H, W, B) and flows (H, W, B, 2): ``clip_flows``
solves all T-1 pairs of a clip in both directions as one batch of 2(T-1)
problems. The reference maps the pairs one at a time for TPU memory and
compile reasons (``flow.py:322-329``); in eager PyTorch a loop over pairs
would cost about 40x the launches of the batch, and the numbers per pair
are the same.

Every warp gather runs through kernel 4 (``kernels.warp``; the batched form
for a batch) at every pyramid level. On the TPU the reference keeps levels
under 128 px on the plain gather (``flow.py:63-66``): the values are the
same, only the launch counts differ. ``VideoParams.fused_flow`` is ignored.
Every Horn-Schunck Jacobi sweep runs through kernel 5
(``kernels.flow.hs_sweep``: one launch a sweep on the card, the plain
version on the CPU, the same bits). Each level opens a ``flow.level`` span
(``h``, ``w``, ``batch``, ``sweeps``); ``_hs_level`` counts kernel 5's
launches there as ``fused_sweeps``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from videomorphing_tpu_torch.config import VideoParams
from videomorphing_tpu_torch.kernels import flow as kflow
from videomorphing_tpu_torch.kernels.warp import bilinear_sample, bilinear_sample_batched
from videomorphing_tpu_torch.ops.pyramid import (
    auto_n_levels,
    gaussian_pyramid,
    pyramid_shapes,
    resize_bilinear,
)
from videomorphing_tpu_torch.ops.resample import grid_coords
from videomorphing_tpu_torch.ops.windows import edge_shifts, gaussian_kernel_1d, separable_filter
from videomorphing_tpu_torch.solver.ctf import resample_field
from videomorphing_tpu_torch.utils import profiling


def _gray(img: torch.Tensor, vp: VideoParams | None = None) -> torch.Tensor:
    """Channel-mean luminance scaled to [0, 255] of (H, W, C) or a batch
    (H, W, B, C); an (H, W) image is already grey.

    In robust mode the structure-texture prefilter follows: ``I -
    gauss_blur(I) + 127.5`` with an edge-padded blur of ``int(4 sigma) | 1``
    taps, which removes the low-frequency band where lighting drift lives.
    """
    g = img.mean(-1) if img.dim() >= 3 else img
    g = g * 255.0
    if vp is not None and vp.flow_robust and vp.flow_hp_sigma > 0:
        sigma = vp.flow_hp_sigma
        k = gaussian_kernel_1d(int(4 * sigma) | 1, sigma, dtype=g.dtype)
        low = separable_filter(g, k, mode="same_edge")
        g = g - low + 127.5
    return g


def _warp_gray(b: torch.Tensor, coords: torch.Tensor, vp: VideoParams) -> torch.Tensor:
    """Sample the grey target at the warped coordinates: (H, W) at
    (H, W, 2), or a batch (H, W, B) at (H, W, B, 2) in one launch."""
    if b.dim() == 2:
        return bilinear_sample(b, coords)
    out = bilinear_sample_batched(b.permute(2, 0, 1)[..., None], coords.permute(2, 0, 1, 3))
    return out[..., 0].permute(1, 2, 0)


def _deriv(f: torch.Tensor):
    """Central differences (dy, dx) of (H, W, ...), edge-replicated (the
    borders degrade to one-sided half-differences)."""
    up, dn, lf, rt = edge_shifts(f)
    return 0.5 * (dn - up), 0.5 * (rt - lf)


def _grid_like(h: int, w: int, u: torch.Tensor) -> torch.Tensor:
    """The (H, W, 2) pixel grid, shaped to broadcast against ``u``."""
    g = grid_coords(h, w, dtype=u.dtype, device=u.device)
    return g.reshape((h, w) + (1,) * (u.dim() - 3) + (2,))


def _hs_level(a: torch.Tensor, b: torch.Tensor, u: torch.Tensor, vp: VideoParams) -> torch.Tensor:
    """Horn-Schunck at one level: ``vp.flow_warps`` outer warps, each with
    ``vp.flow_iters`` Jacobi sweeps on the total flow, the data term
    linearized at the warp's start and each warp's correction clamped to
    ``vp.flow_clamp``. The sweeps that launched kernel 5 add to the open
    span's ``fused_sweeps`` counter."""
    h, w = a.shape[0], a.shape[1]
    g = _grid_like(h, w, u)
    alpha2 = vp.flow_alpha * vp.flow_alpha

    u = u.contiguous()
    bufs = (torch.empty_like(u), torch.empty_like(u))  # the sweeps write these in turn
    launched = kflow.hs_sweep.launches

    for _ in range(vp.flow_warps):
        u_w = u
        bw = _warp_gray(b, g + u_w, vp).contiguous()  # kernel 4 gives (B, H, W): the sweeps take (H, W, B)
        it = bw - a
        iy, ix = _deriv(bw)
        denom = alpha2 + ix * ix + iy * iy
        ut = u_w
        for k in range(vp.flow_iters):
            ut = kflow.hs_sweep(ut, u_w, it, ix, iy, denom, bufs[k % 2])
        u = u_w + torch.clamp(ut - u_w, -vp.flow_clamp, vp.flow_clamp)
    fused = kflow.hs_sweep.launches - launched
    if fused:
        profiling.count("fused_sweeps", fused)
    return u


def _robust_level(a: torch.Tensor, b: torch.Tensor, u: torch.Tensor, vp: VideoParams) -> torch.Tensor:
    """Brox-class robust flow at one level (``VideoParams.flow_robust``):
    a coupled Charbonnier penalty on the intensity and gradient-constancy
    residuals and TV-like smoothness, as lagged IRLS weights around damped
    Jacobi sweeps that solve each pixel's 2x2 normal matrix in closed form.
    ``flow_iters`` splits as ``max(flow_iters // flow_irls, 1)`` sweeps per
    IRLS step."""
    h, w = a.shape[0], a.shape[1]
    g = _grid_like(h, w, u)
    alpha2 = vp.flow_alpha_robust * vp.flow_alpha_robust
    eps2 = vp.flow_eps * vp.flow_eps
    eps2_s = vp.flow_eps_s * vp.flow_eps_s
    gamma = vp.flow_gamma
    ay, ax = _deriv(a)

    for _ in range(vp.flow_warps):
        u_w = u
        bw = _warp_gray(b, g + u_w, vp)
        bwy, bwx = _deriv(bw)
        byy, byx = _deriv(bwy)
        bxy, bxx = _deriv(bwx)
        # (temporal residual at u_w, d/dy, d/dx, weight) per data channel
        chans = (
            (bw - a, bwy, bwx, 1.0),
            (bwy - ay, byy, byx, gamma),
            (bwx - ax, bxy, bxx, gamma),
        )
        n_irls = vp.flow_irls
        inner = max(vp.flow_iters // n_irls, 1)

        ut = u_w
        for _ in range(n_irls):
            du = ut - u_w
            ws = []
            for n in edge_shifts(ut):
                d = n - ut
                ws.append(1.0 / torch.sqrt(torch.sum(d * d, -1) + eps2_s))
            wsum = ws[0] + ws[1] + ws[2] + ws[3]
            s = alpha2 * wsum * 0.25

            r2_sum = torch.zeros_like(s)
            for it_c, gy_c, gx_c, cw in chans:
                r = it_c + gy_c * du[..., 0] + gx_c * du[..., 1]
                r2_sum = r2_sum + cw * r * r
            w_pix = 1.0 / torch.sqrt(r2_sum + eps2)

            a11 = s
            a12 = torch.zeros_like(s)
            a22 = s
            b1 = torch.zeros_like(s)
            b2 = torch.zeros_like(s)
            for it_c, gy_c, gx_c, cw in chans:
                wc = cw * w_pix
                a11 = a11 + wc * gy_c * gy_c
                a12 = a12 + wc * gy_c * gx_c
                a22 = a22 + wc * gx_c * gx_c
                c = it_c - gy_c * u_w[..., 0] - gx_c * u_w[..., 1]
                b1 = b1 - wc * gy_c * c
                b2 = b2 - wc * gx_c * c
            det = a11 * a22 - a12 * a12

            for _ in range(inner):
                un_u, un_d, un_l, un_r = edge_shifts(ut)
                ua = (
                    ws[0][..., None] * un_u + ws[1][..., None] * un_d
                    + ws[2][..., None] * un_l + ws[3][..., None] * un_r
                ) / wsum[..., None]
                r1 = s * ua[..., 0] + b1
                r2 = s * ua[..., 1] + b2
                uy = (a22 * r1 - a12 * r2) / det
                ux = (a11 * r2 - a12 * r1) / det
                ut = 0.5 * ut + 0.5 * torch.stack([uy, ux], -1)
        u = u_w + torch.clamp(ut - u_w, -vp.flow_clamp, vp.flow_clamp)
    return u


def _level_solver(vp: VideoParams):
    return _robust_level if vp.flow_robust else _hs_level


def _sweeps(vp: VideoParams) -> int:
    """The Jacobi sweeps of one level of :func:`_level_solver`."""
    if vp.flow_robust:
        return vp.flow_warps * vp.flow_irls * max(vp.flow_iters // vp.flow_irls, 1)
    return vp.flow_warps * vp.flow_iters


def _flow_downscale(x: torch.Tensor, vp: VideoParams) -> torch.Tensor:
    """The ``flow_scale`` shrink of (H, W, ...) frames: the flow only
    warm-starts and regularizes the halfway solve, so it runs at reduced
    resolution (an antialiased linear resize, as ``jax.image.resize``)."""
    h0, w0 = x.shape[0], x.shape[1]
    if vp.flow_scale < 1.0:
        hs = max(int(round(h0 * vp.flow_scale)), 16)
        ws = max(int(round(w0 * vp.flow_scale)), 16)
        x = resize_bilinear(x, (hs, ws))
    return x


def _gray_pyramid(frames: torch.Tensor, vp: VideoParams) -> List[torch.Tensor]:
    """(H, W, B, C) colour frames -> Gaussian pyramid of their grey images
    at the flow's working resolution, finest first, each level (h, w, B)."""
    g = _gray(_flow_downscale(frames, vp), vp)
    n_levels = vp.flow_levels or auto_n_levels(g.shape[0], g.shape[1], 16)
    return gaussian_pyramid(g, n_levels)


def _flow_solve(pyr_a: List[torch.Tensor], pyr_b: List[torch.Tensor], vp: VideoParams) -> torch.Tensor:
    """Coarse-to-fine solve over grey pyramids (levels (h, w, B), finest
    first): the (h, w, B, 2) flows with b(p + u) ~ a(p) at the finest."""
    h, w, nb = pyr_a[0].shape
    shapes = pyramid_shapes(h, w, len(pyr_a))
    solve = _level_solver(vp)
    u = pyr_a[0].new_zeros(shapes[-1] + (nb, 2))
    for level in range(len(pyr_a) - 1, -1, -1):
        with profiling.span("flow.level", h=shapes[level][0], w=shapes[level][1], batch=nb, sweeps=_sweeps(vp)):
            u = solve(pyr_a[level], pyr_b[level], u, vp)
        if level > 0:
            u = resample_field(u, shapes[level - 1])
    return u


def _solve_frames(frames: torch.Tensor, pairs: Tuple[List[int], List[int]], vp: VideoParams) -> torch.Tensor:
    """Flows between frames ``pairs[0][k] -> pairs[1][k]`` of (H, W, T, C)
    colour frames as one batch: (H, W, K, 2) at full resolution. Each frame
    is shrunk, greyed and pyramided once, however many pairs it is in."""
    h0, w0 = frames.shape[0], frames.shape[1]
    pyr = _gray_pyramid(frames, vp)
    src, dst = pairs
    u = _flow_solve([p[:, :, src] for p in pyr], [p[:, :, dst] for p in pyr], vp)
    return u if tuple(u.shape[:2]) == (h0, w0) else resample_field(u, (h0, w0))


def flow_pair(a: torch.Tensor, b: torch.Tensor, vp: VideoParams = VideoParams()) -> torch.Tensor:
    """Dense flow u with b(p + u(p)) ~ a(p); (H, W, 2) in (dy, dx)."""
    return _solve_frames(torch.stack([a, b], 2), ([0], [1]), vp)[:, :, 0]


def flow_pair_bidir(
    a: torch.Tensor, b: torch.Tensor, vp: VideoParams = VideoParams()
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both flow directions of one frame pair: (a->b, b->a), sharing the
    shrink, grey conversion and pyramids, solved as one batch of two."""
    u = _solve_frames(torch.stack([a, b], 2), ([0, 1], [1, 0]), vp)
    return u[:, :, 0], u[:, :, 1]


def _pair_flows(clip: torch.Tensor, pairs: List[int], vp: VideoParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both flows of the consecutive-frame pairs ``t -> t+1`` for t in
    ``pairs`` (ascending) of (T, H, W, C), as one batch: ``(fwd, bwd)``,
    each (len(pairs), H, W, 2). Only the frames the pairs touch are
    shrunk and pyramided."""
    lo = pairs[0]
    frames = clip[lo:pairs[-1] + 2]
    src = [t - lo for t in pairs] + [t + 1 - lo for t in pairs]
    dst = [t + 1 - lo for t in pairs] + [t - lo for t in pairs]
    n = len(pairs)
    u = _solve_frames(frames.permute(1, 2, 0, 3), (src, dst), vp).permute(2, 0, 1, 3)
    return u[:n].contiguous(), u[n:].contiguous()


def clip_flows(clip: torch.Tensor, vp: VideoParams = VideoParams()) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward and backward flows between consecutive frames of (T, H, W, C).

    Returns ``(fwd, bwd)``, each (T-1, H, W, 2): ``fwd[t]`` maps frame t to
    t+1 (sampled at t), ``bwd[t]`` maps frame t+1 back to t. All 2(T-1)
    problems run as one batch.
    """
    return _pair_flows(clip, list(range(clip.shape[0] - 1)), vp)


def clip_flows_sharded(
    clip: torch.Tensor, vp: VideoParams, mesh, axis: str = "batch"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`clip_flows` with the T-1 frame pairs split over the mesh:
    each device solves its contiguous share as one batch. The pairs pad to a
    multiple of the axis size by repeating the last pair, as the
    reference's; the results gather on the clip's device and are trimmed."""
    from videomorphing_tpu_torch.parallel.frames import shares
    from videomorphing_tpu_torch.parallel.mesh import as_mesh

    devs = as_mesh(mesh).axis_devices(axis)
    n = clip.shape[0] - 1
    n_pad = n + (-n) % len(devs)
    fwd, bwd = [], []
    for dev, sl in zip(devs, shares(n_pad, len(devs))):
        pairs = [min(t, n - 1) for t in range(sl.start, sl.stop)]
        lo = pairs[0]
        f, b = _pair_flows(clip[lo:pairs[-1] + 2].to(dev), [t - lo for t in pairs], vp)
        fwd.append(f.to(clip.device))
        bwd.append(b.to(clip.device))
    return torch.cat(fwd, 0)[:n].contiguous(), torch.cat(bwd, 0)[:n].contiguous()
