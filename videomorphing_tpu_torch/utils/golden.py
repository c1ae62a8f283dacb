"""Golden-field midpoint fidelity (port of ``videomorphing_tpu/utils/golden.py``):
synthetic pairs whose true halfway field and true midpoint frame are known
in closed form. The images are sums of band-limited cosine waves, pure
functions of (y, x), so ``i0``, ``i1`` and the analytic midpoint are exact
point evaluations, never resampled.

Cases (the derivations are in the reference's docstrings):

- ``translation``: I1 is I0 shifted by 2u; v = u, M(q) = tex(q - u);
- ``rotation``: I1 is I0 rotated by 2 theta about the center;
  v(p) = tan(theta) J (p - c), and the midpoint is I0 rotated by theta;
- ``scale``: I1 is I0 zoomed by k; v(p) = ((k-1)/(k+1)) (p - c).

The reference draws each texture's waves with ``jax.random``, which the
port may not import: here :func:`texture_params` draws the same four
arrays with a numpy ``Generator``, and every case takes them as
``params=``, so a test can hand both packages the same draws. The port's
seed-0 texture is therefore not the reference's seed-0 texture.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from videomorphing_tpu_torch.device import as_device

# (log period, angle, phase, raw amplitude), each (channels, n_waves) float32
TextureParams = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


class GoldenCase(NamedTuple):
    i0: torch.Tensor        # (H, W, C)
    i1: torch.Tensor        # (H, W, C)
    mid_true: torch.Tensor  # (H, W, C) analytic frame at t = 0.5
    v_true: torch.Tensor    # (H, W, 2) analytic halfway field
    crop: int               # interior-crop margin for metrics (boundary_lock
    #                         pins the solved field at edges where v_true != 0)


def texture_params(seed, channels: int = 3, n_waves: int = 24,
                   min_period: float = 10.0, max_period: float = 80.0) -> TextureParams:
    """The four raw draws of a texture, as the reference draws them (log
    period uniform in [log min, log max), angle and phase in [0, 2 pi),
    amplitude in [0.5, 1)), from ``numpy.random.default_rng(seed)`` (``seed``
    an int or a ``Generator``)."""
    rng = np.random.default_rng(seed)
    shape = (channels, n_waves)
    draw = lambda lo, hi: rng.uniform(lo, hi, shape).astype(np.float32)
    log_period = draw(np.log(min_period), np.log(max_period))
    ang = draw(0.0, 2.0 * np.pi)
    psi = draw(0.0, 2.0 * np.pi)
    amp = draw(0.5, 1.0)
    return log_period, ang, psi, amp


def _texture(params: TextureParams, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Band-limited texture at float coordinates (H, W) -> (H, W, C):
    tex(y, x) = 0.5 + sum_k a_k cos(wy_k y + wx_k x + psi_k) per channel,
    amplitudes normalized so values stay in [0, 1]."""
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=ys.device)
    log_period, ang, psi, amp = (t(a) for a in params)
    # a float32 2 pi over the period, one rounding, as the reference divides
    omega = torch.div(t(2.0 * np.pi), torch.exp(log_period))
    wy = omega * torch.sin(ang)
    wx = omega * torch.cos(ang)
    amp = 0.48 * amp / torch.sum(amp, dim=1, keepdim=True)
    phase = ys[..., None, None] * wy + xs[..., None, None] * wx + psi  # (H, W, C, K)
    return 0.5 + torch.sum(amp * torch.cos(phase), dim=-1)


def _grid(h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = as_device(device)
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None] * torch.ones((1, w), device=dev)
    xs = torch.ones((h, 1), device=dev) * torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    return ys, xs


def translation_case(
    h: int = 256, w: int = 256, shift: Tuple[float, float] = (2.5, 4.0),
    seed: int = 0, channels: int = 3, params: Optional[TextureParams] = None, device=None,
) -> GoldenCase:
    """I1(q) = tex(q - 2u): true v = u, true midpoint M(q) = tex(q - u)."""
    params = texture_params(seed, channels) if params is None else params
    uy, ux = float(shift[0]), float(shift[1])
    ys, xs = _grid(h, w, device)
    i0 = _texture(params, ys, xs)
    i1 = _texture(params, ys - 2.0 * uy, xs - 2.0 * ux)
    mid = _texture(params, ys - uy, xs - ux)
    v_true = torch.tensor([uy, ux], dtype=torch.float32, device=ys.device).expand(h, w, 2).contiguous()
    crop = int(np.ceil(2 * max(abs(uy), abs(ux)))) + 12
    return GoldenCase(i0=i0, i1=i1, mid_true=mid, v_true=v_true, crop=crop)


def rotation_case(
    h: int = 256, w: int = 256, theta: float = 0.04, seed: int = 1,
    channels: int = 3, params: Optional[TextureParams] = None, device=None,
) -> GoldenCase:
    """I1 = I0 rotated by 2 theta about the center; the circular paths pass
    through the theta-rotation at t = 0.5."""
    params = texture_params(seed, channels) if params is None else params
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys, xs = _grid(h, w, device)
    ry, rx = ys - cy, xs - cx

    def rot_coords(a):
        c, s = float(np.cos(a)), float(np.sin(a))
        # rotate the SAMPLING coordinates by -a to rotate the image by +a
        return cy + c * ry + s * rx, cx - s * ry + c * rx

    i0 = _texture(params, ys, xs)
    i1 = _texture(params, *rot_coords(2.0 * theta))
    mid = _texture(params, *rot_coords(theta))
    t = float(np.tan(theta))
    v_true = torch.stack([-t * rx, t * ry], dim=-1)
    crop = int(np.ceil(2.0 * abs(theta) * float(np.hypot(cy, cx)))) + 12
    return GoldenCase(i0=i0, i1=i1, mid_true=mid, v_true=v_true, crop=crop)


def scale_case(
    h: int = 256, w: int = 256, k: float = 1.1, seed: int = 2,
    channels: int = 3, params: Optional[TextureParams] = None, device=None,
) -> GoldenCase:
    """I1 is I0 zoomed by ``k`` about the center: a divergent true field,
    v(p) = ((k-1)/(k+1)) (p - c), with straight paths (the bulge must
    vanish)."""
    params = texture_params(seed, channels) if params is None else params
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys, xs = _grid(h, w, device)
    ry, rx = ys - cy, xs - cx
    i0 = _texture(params, ys, xs)
    i1 = _texture(params, cy + ry / k, cx + rx / k)
    a_mid = 2.0 / (k + 1.0)
    mid = _texture(params, cy + a_mid * ry, cx + a_mid * rx)
    alpha = (k - 1.0) / (k + 1.0)
    v_true = torch.stack([alpha * ry, alpha * rx], dim=-1)
    crop = int(np.ceil(abs(k - 1.0) * float(np.hypot(cy, cx)))) + 12
    return GoldenCase(i0=i0, i1=i1, mid_true=mid, v_true=v_true, crop=crop)


CASES = {"translation": translation_case, "rotation": rotation_case, "scale": scale_case}


def ssim(a: torch.Tensor, b: torch.Tensor, crop: int = 0) -> float:
    """1 - mean DSSIM of two (H, W, C) images, ``crop`` pixels off each edge."""
    from videomorphing_tpu_torch.ops.ssim import dssim_map

    if crop:
        a, b = a[crop:-crop, crop:-crop], b[crop:-crop, crop:-crop]
    return 1.0 - float(torch.mean(dssim_map(a, b)))


def run_golden(
    case: str = "translation",
    hw: Tuple[int, int] = (256, 256),
    mp=None,
    sp=None,
    seed: int = 0,
    params: Optional[TextureParams] = None,
    device=None,
) -> dict:
    """Solve and render t = 0.5 on a golden case on ``device`` (default the
    card); report the SSIM against the analytic midpoint and the field error
    against the analytic field.

    Returns ``{"case", "ssim_mid", "v_err_mean", "v_err_p99", "crop"}``
    (rounded as the reference rounds them). The BASELINE gate analogue is
    ``ssim_mid >= 0.99``.
    """
    from videomorphing_tpu_torch.config import MorphParams, SynthParams
    from videomorphing_tpu_torch.models.image_morph import ImageMorpher

    if case not in CASES:
        raise ValueError(f"unknown golden case {case!r}")
    mp = mp if mp is not None else MorphParams()
    sp = sp if sp is not None else SynthParams()
    dev = as_device(device)
    g = CASES[case](hw[0], hw[1], seed=seed, params=params, device=dev)
    morpher = ImageMorpher(mp, sp, str(dev))
    art = morpher.solve(g.i0, g.i1)
    frame = morpher.render_one(g.i0, g.i1, art, 0.5)
    c = g.crop
    sl = (slice(c, -c), slice(c, -c))
    err = torch.linalg.norm(art.v[sl] - g.v_true[sl], dim=-1)
    return {
        "case": case,
        "ssim_mid": round(ssim(frame, g.mid_true, crop=c), 5),
        "v_err_mean": round(float(torch.mean(err)), 4),
        "v_err_p99": round(float(torch.quantile(err.reshape(-1), 0.99)), 4),
        "crop": c,
    }
