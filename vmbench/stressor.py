"""The benchmark's stressor takes, made on the device from a seed.

A frozen copy of the program's stressor clip formula (a band-limited
background texture panning slowly, a textured disk moving fast over it, a
lighting gain of +-``drift`` with its own phase per take; take B has the
disk path and the background displaced by constant offsets) that makes
only the two clips and the disk-centre point pair on frame 0: no mid
frames and no ground-truth masks. The textures' wave draws come from
``numpy.random.default_rng(seed)``, the background's first.
"""

from __future__ import annotations

import numpy as np
import torch


def texture_params(rng, channels: int = 3, n_waves: int = 24,
                   min_period: float = 10.0, max_period: float = 80.0) -> tuple:
    """A texture's four draws (log period, angle, phase, amplitude), each
    (channels, n_waves) float32, from the numpy generator ``rng``."""
    shape = (channels, n_waves)
    draw = lambda lo, hi: rng.uniform(lo, hi, shape).astype(np.float32)
    log_period = draw(np.log(min_period), np.log(max_period))
    ang = draw(0.0, 2.0 * np.pi)
    psi = draw(0.0, 2.0 * np.pi)
    amp = draw(0.5, 1.0)
    return log_period, ang, psi, amp


def texture(params: tuple, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """The texture at float coordinates (H, W) -> (H, W, C) in [0, 1]:
    0.5 + sum_k a_k cos(wy_k y + wx_k x + psi_k) per channel."""
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=ys.device)
    log_period, ang, psi, amp = (t(a) for a in params)
    omega = torch.div(t(2.0 * np.pi), torch.exp(log_period))
    wy = omega * torch.sin(ang)
    wx = omega * torch.cos(ang)
    amp = 0.48 * amp / torch.sum(amp, dim=1, keepdim=True)
    phase = ys[..., None, None] * wy + xs[..., None, None] * wx + psi  # (H, W, C, K)
    return 0.5 + torch.sum(amp * torch.cos(phase), dim=-1)


def make_takes(t_len: int, h: int, w: int, seed: int, device, drift: float = 0.12,
               edge: float = 1.5) -> tuple:
    """Two takes (t_len, h, w, 3) float32 in [0, 1] on ``device`` and the
    disk-centre pair (1, 2, 2) float32 [[y0, x0], [y1, x1]] on frame 0.
    ``drift``: the lighting gain's amplitude; ``edge``: the disk boundary's
    soft width in px."""
    dev = torch.device(device)
    rng = np.random.default_rng(int(seed))
    p_bg = texture_params(rng)
    p_fg = texture_params(rng, 3, 16, 6.0, 40.0)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    scale = min(h, w)

    vb = f32([0.12, -0.30]) * (scale / 480.0)  # background px/frame
    vf = f32([0.6 * scale / 480.0, 0.40 * w / max(t_len - 1, 1)])  # disk px/frame
    r = 0.16 * scale
    c0_a = f32([0.52 * h, 0.28 * w])
    d = f32((0.10 * h, -0.04 * w))  # B's disk path minus A's
    bd = f32([0.020 * h, 0.015 * w])  # B's background offset

    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None] * torch.ones((1, w), device=dev)
    xs = torch.ones((h, 1), device=dev) * torch.arange(w, dtype=torch.float32, device=dev)[None, :]

    def frame(t, off, bg_off, phase):
        g = 1.0 + drift * torch.sin(f32(2.0 * np.pi * t / max(t_len, 2) * 0.9 + phase))
        bg = texture(p_bg, ys - vb[0] * t - bg_off[0], xs - vb[1] * t - bg_off[1])
        c = c0_a + vf * t + off
        fg = texture(p_fg, ys - c[0], xs - c[1])
        m = torch.sigmoid((r - torch.sqrt((ys - c[0]) ** 2 + (xs - c[1]) ** 2)) / edge)[..., None]
        out = (0.25 + 0.5 * bg) * (1.0 - m) + (0.2 + 0.6 * fg) * m
        return torch.clamp(g * out, 0.0, 1.0)

    zero = torch.zeros(2, device=dev)
    clip_a = torch.stack([frame(t, zero, zero, 0.3) for t in range(t_len)])
    clip_b = torch.stack([frame(t, d, bd, 1.5) for t in range(t_len)])
    points = np.asarray([[c0_a.tolist(), (c0_a + d).tolist()]], np.float32)
    return clip_a, clip_b, points
