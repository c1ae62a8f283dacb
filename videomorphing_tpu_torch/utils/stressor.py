"""Real-footage-class stressor with analytic ground truth: moving occluders,
motion discontinuities and lighting drift (port of
``videomorphing_tpu/utils/stressor.py``).

The scene is a pure function of coordinates and time, so every quantity
the video pipeline estimates has a closed-form true value:

- a band-limited background texture panning slowly (non-zero flow
  everywhere);
- a textured foreground disk moving fast over it (a motion discontinuity
  at its boundary and an occlusion band every frame);
- a global lighting gain that oscillates per frame, with another phase
  per clip (the brightness-constancy violation the robust flow is for).

Clip B is the same scene with the disk path and the background displaced
by constant offsets and its own lighting phase, so the true blend-0.5
frame is the scene at the midpoint geometry with averaged lighting.

The textures are ``utils.golden._texture`` evaluations; their wave draws
come from ``golden.texture_params`` (numpy), or from ``params=`` (the
background's, then the disk's), so a test can hand both packages the same
draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from videomorphing_tpu_torch.device import as_device
from videomorphing_tpu_torch.utils.golden import TextureParams, _texture, texture_params


class StressorCase(NamedTuple):
    clip_a: torch.Tensor       # (T, H, W, 3)
    clip_b: torch.Tensor       # (T, H, W, 3)
    mid_true: torch.Tensor     # (T, H, W, 3) true blend-0.5 morph frames
    flow_a_true: torch.Tensor  # (T-1, H, W, 2) true forward flow of clip A (dy, dx)
    flow_b_true: torch.Tensor  # (T-1, H, W, 2)
    valid_a: torch.Tensor      # (T-1, H, W) bool: flow well defined (visible in
    #                            both frames, off the discontinuity band)
    valid_b: torch.Tensor      # (T-1, H, W) bool
    occ_a: torch.Tensor        # (T-1, H, W) bool: frame-t pixel occluded at t+1
    occ_b: torch.Tensor        # (T-1, H, W) bool
    disk_a: torch.Tensor       # (T-1, H, W) bool: frame-t pixel on the disk
    disk_b: torch.Tensor       # (T-1, H, W) bool
    points: np.ndarray         # (1, 2, 2) frame-0 disk-center correspondence
    crop: int                  # interior crop for frame metrics
    disk_offset: Tuple[float, float]  # B-vs-A disk displacement (dy, dx)


def make_stressor(
    t_len: int = 8,
    h: int = 480,
    w: int = 854,
    seed: int = 0,
    drift: float = 0.12,
    edge: float = 1.5,
    params: Optional[Tuple[TextureParams, TextureParams]] = None,
    device=None,
) -> StressorCase:
    """The stressor clips and their ground truth at (t_len, h, w) on
    ``device`` (default the card).

    ``drift``: lighting gain oscillation amplitude (0.12 = +-12 % per
    clip). ``edge``: soft anti-aliasing width of the disk boundary in px
    (the ground-truth masks exclude a 3 edge band around the boundary,
    where foreground and background flow are ambiguous). ``params``: the
    background's and the disk's texture draws (default: both drawn from
    ``numpy.random.default_rng(seed)``, the background's first).
    """
    dev = as_device(device)
    if params is None:
        rng = np.random.default_rng(seed)
        params = (texture_params(rng), texture_params(rng, 3, 16, 6.0, 40.0))
    p_bg, p_fg = params
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    scale = min(h, w)

    vb = f32([0.12, -0.30]) * (scale / 480.0)  # background px/frame
    # the disk crosses ~40 % of the width over the clip, whatever T is
    vf = f32([0.6 * scale / 480.0, 0.40 * w / max(t_len - 1, 1)])
    r = 0.16 * scale
    c0_a = f32([0.52 * h, 0.28 * w])  # A's disk path start
    d_off = (0.10 * h, -0.04 * w)     # B minus A: a dissolve visibly ghosts
    d = f32(d_off)
    bd = f32([0.020 * h, 0.015 * w])  # B's background offset: v != 0 everywhere

    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None] * torch.ones((1, w), device=dev)
    xs = torch.ones((h, 1), device=dev) * torch.arange(w, dtype=torch.float32, device=dev)[None, :]

    def center(t, off):
        return c0_a + vf * t + off

    def gain(t, phase):
        return 1.0 + drift * torch.sin(f32(2.0 * np.pi * t / max(t_len, 2) * 0.9 + phase))

    def dist_to(c):
        return torch.sqrt((ys - c[0]) ** 2 + (xs - c[1]) ** 2)

    def frame(t, off, bg_off, phase, mid_of=None):
        """Scene at time t; ``mid_of=(off_b, bg_off_b, phase_b)`` renders
        the true blend-0.5 morph frame (midpoint geometry and lighting)."""
        if mid_of is None:
            off_g, bg_g, g = off, bg_off, gain(t, phase)
        else:
            off_b, bg_off_b, phase_b = mid_of
            off_g = 0.5 * (off + off_b)
            bg_g = 0.5 * (bg_off + bg_off_b)
            g = 0.5 * (gain(t, phase) + gain(t, phase_b))
        bg = _texture(p_bg, ys - vb[0] * t - bg_g[0], xs - vb[1] * t - bg_g[1])
        c = center(t, off_g)
        fg = _texture(p_fg, ys - c[0], xs - c[1])
        m = torch.sigmoid((r - dist_to(c)) / edge)[..., None]
        out = (0.25 + 0.5 * bg) * (1.0 - m) + (0.2 + 0.6 * fg) * m
        return torch.clamp(g * out, 0.0, 1.0)

    zero = torch.zeros(2, device=dev)
    phase_a, phase_b = 0.3, 1.5
    clip_a = torch.stack([frame(t, zero, zero, phase_a) for t in range(t_len)])
    clip_b = torch.stack([frame(t, d, bd, phase_b) for t in range(t_len)])
    mid = torch.stack([frame(t, zero, zero, phase_a, mid_of=(d, bd, phase_b)) for t in range(t_len)])

    truth = {k: [] for k in ("fa", "fb", "va", "vb", "oa", "ob", "da", "db")}
    py, px = ys + vb[0], xs + vb[1]  # where a background pixel goes at t+1
    for t in range(t_len - 1):
        for off, sfx in ((zero, "a"), (d, "b")):
            dist_t = dist_to(center(t, off))
            in_t = dist_t < r
            truth["d" + sfx].append(in_t)
            # disk pixels move with vf, background pixels with vb
            flow = torch.where(in_t[..., None], vf, vb).expand(h, w, 2)
            truth["f" + sfx].append(flow)
            c1 = center(t + 1, off)
            d2_t1 = (py - c1[0]) ** 2 + (px - c1[1]) ** 2
            # occluded: a background pixel whose next position lies in the disk
            occ = ~in_t & (d2_t1 < r**2)
            truth["o" + sfx].append(occ)
            band_t = (dist_t < r + 3 * edge) & ~(dist_t < r - 3 * edge)
            band_t1 = (d2_t1 < (r + 3 * edge) ** 2) & (d2_t1 > (r - 3 * edge) ** 2)
            ty, tx = ys + flow[..., 0], xs + flow[..., 1]
            inb = (ty >= 1) & (ty <= h - 2) & (tx >= 1) & (tx <= w - 2)
            truth["v" + sfx].append(~occ & ~band_t & ~band_t1 & inb)
    st = {k: torch.stack(v) for k, v in truth.items()}

    pts = np.asarray([[c0_a.tolist(), (c0_a + d).tolist()]], np.float32)
    # interior crop: soft-edge band + pan drift + the boundary-locked solve's
    # disagreement with the global bd/2 halfway displacement
    crop = int(np.ceil(3 * edge + float(vb.abs().max()) * t_len + 2.0 * float(bd.abs().max()))) + 12
    return StressorCase(
        clip_a=clip_a, clip_b=clip_b, mid_true=mid,
        flow_a_true=st["fa"], flow_b_true=st["fb"], valid_a=st["va"], valid_b=st["vb"],
        occ_a=st["oa"], occ_b=st["ob"], disk_a=st["da"], disk_b=st["db"], points=pts, crop=crop,
        disk_offset=(float(d[0]), float(d[1])),
    )


# ---------------------------------------------------------------- metrics


def flow_epe(flow: torch.Tensor, true: torch.Tensor, valid: torch.Tensor) -> dict:
    """Endpoint error of estimated vs true flow over the valid mask:
    ``flow``/``true`` (T-1, H, W, 2), ``valid`` (T-1, H, W) bool. The 95th
    percentile interpolates linearly, as ``jnp.percentile`` does."""
    err = torch.linalg.norm(flow - true, dim=-1)
    v = valid.to(err.dtype)
    n = torch.clamp(torch.sum(v), min=1.0)
    mean = torch.sum(err * v) / n
    big = torch.where(valid, err, 0.0)
    return {
        "epe_mean": float(mean),
        "epe_p95": float(torch.quantile(big[valid], 0.95)) if bool(valid.any()) else float("nan"),
        "frac_gt1px": float(torch.sum((err > 1.0) * v) / n),
    }


def occlusion_f1(conf: torch.Tensor, occ_true: torch.Tensor, thresh: float = 0.5) -> dict:
    """Occlusion detection quality, predicted occluded = confidence < thresh:
    ``conf`` (T-1, H, W) visibility in [0, 1] (1 = visible), ``occ_true``
    (T-1, H, W) bool."""
    pred = conf < thresh
    tp = float(torch.sum(pred & occ_true))
    fp = float(torch.sum(pred & ~occ_true))
    fn = float(torch.sum(~pred & occ_true))
    prec = tp / max(tp + fp, 1.0)
    rec = tp / max(tp + fn, 1.0)
    f1 = 2 * prec * rec / max(prec + rec, 1e-9)
    return {"precision": prec, "recall": rec, "f1": f1}


def midframe_ssim(frames: torch.Tensor, case: StressorCase) -> dict:
    """SSIM of rendered blend-0.5 frames against the analytic mid frames."""
    from videomorphing_tpu_torch.utils.golden import ssim

    vals = [ssim(frames[t], case.mid_true[t], crop=case.crop) for t in range(frames.shape[0])]
    return {
        "ssim_mid_mean": float(np.mean(vals)),
        "ssim_mid_min": float(np.min(vals)),
        "per_frame": [round(float(v), 5) for v in vals],
    }
