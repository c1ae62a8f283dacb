"""Bilinear and bicubic sampling and coordinate grids.

Port of ``videomorphing_tpu/ops/resample.py``. The gathers index the
flattened ``(H*W, C)`` image directly; ``F.grid_sample`` is not used
because it normalizes coordinates and rounds differently from the
reference's edge-clamp rule. These functions are the plain versions of the
warp and sampler kernels (``kernels/warp.py``).

Conventions: images ``(H, W, C)``, fields ``(H, W, 2)`` ordered
``(dy, dx)``; pixel (i, j) sits at coordinate (i, j).
"""

from __future__ import annotations

import torch


def grid_coords(h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Pixel-center coordinate grid, shape (H, W, 2) ordered (y, x)."""
    ys = torch.arange(h, dtype=dtype, device=device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=dtype, device=device)[None, :].expand(h, w)
    return torch.stack([ys, xs], dim=-1)


def inside_mask(coords: torch.Tensor, h: int, w: int, margin: float = 0.0) -> torch.Tensor:
    """1.0 where (y, x) falls inside the image rectangle, else 0.0."""
    y = coords[..., 0]
    x = coords[..., 1]
    ok = (y >= margin) & (y <= (h - 1) - margin) & (x >= margin) & (x <= (w - 1) - margin)
    return ok.to(coords.dtype)


def _corners(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor, base=0):
    """Clamped-coordinate corner taps and fractions of a bilinear sample of
    ``img`` (..., H, W, C); ``base`` offsets each flat index to its image
    (0 for one image)."""
    h, w, c = img.shape[-3:]
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    fy = (y - y0)[..., None]
    fx = (x - x0)[..., None]
    y0i = y0.long()
    x0i = x0.long()
    y1i = torch.clamp(y0i + 1, max=h - 1)
    x1i = torch.clamp(x0i + 1, max=w - 1)
    flat = img.reshape(-1, c)

    def take(yi, xi):
        return flat[base + yi * w + xi]

    return take(y0i, x0i), take(y0i, x1i), take(y1i, x0i), take(y1i, x1i), fy, fx


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinearly sample ``img`` (H, W, C) or (H, W) at ``coords`` (..., 2).

    Out-of-range coordinates clamp to the edge.
    """
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    h, w = img.shape[0], img.shape[1]
    y = torch.clamp(coords[..., 0], 0.0, h - 1.0)
    x = torch.clamp(coords[..., 1], 0.0, w - 1.0)
    v00, v01, v10, v11, fy, fx = _corners(img, y, x)
    top = v00 + (v01 - v00) * fx
    bot = v10 + (v11 - v10) * fx
    out = top + (bot - top) * fy
    return out[..., 0] if squeeze else out


def bilinear_sample_batched(imgs: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """``bilinear_sample(imgs[k], coords[k])`` for every k in one pass:
    ``imgs`` (n, H, W, C), ``coords`` (n, ..., 2) -> (n, ..., C). The same
    operations per value as :func:`bilinear_sample`, so the results are
    bitwise equal to a loop over k."""
    n, h, w = imgs.shape[0], imgs.shape[1], imgs.shape[2]
    y = torch.clamp(coords[..., 0], 0.0, h - 1.0)
    x = torch.clamp(coords[..., 1], 0.0, w - 1.0)
    base = torch.arange(n, device=imgs.device) * (h * w)
    base = base.reshape((n,) + (1,) * (coords.dim() - 2))
    v00, v01, v10, v11, fy, fx = _corners(imgs, y, x, base)
    top = v00 + (v01 - v00) * fx
    bot = v10 + (v11 - v10) * fx
    return top + (bot - top) * fy


def bilinear_sample_with_grad(img: torch.Tensor, coords: torch.Tensor):
    """Bilinear sample plus the exact derivative of the interpolant.

    Returns ``(value (..., C), dval (..., C, 2))`` with ``dval`` =
    d value / d (y, x), zero where the raw coordinate is clamped (the strict
    tests ``0 < y < h - 1``).
    """
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    h, w = img.shape[0], img.shape[1]
    y_raw = coords[..., 0]
    x_raw = coords[..., 1]
    y = torch.clamp(y_raw, 0.0, h - 1.0)
    x = torch.clamp(x_raw, 0.0, w - 1.0)
    dy_ok = ((y_raw > 0.0) & (y_raw < h - 1.0)).to(img.dtype)[..., None]
    dx_ok = ((x_raw > 0.0) & (x_raw < w - 1.0)).to(img.dtype)[..., None]
    v00, v01, v10, v11, fy, fx = _corners(img, y, x)
    top = v00 + (v01 - v00) * fx
    bot = v10 + (v11 - v10) * fx
    val = top + (bot - top) * fy
    dval_dy = (bot - top) * dy_ok
    dval_dx = ((v01 - v00) * (1.0 - fy) + (v11 - v10) * fy) * dx_ok
    dval = torch.stack([dval_dy, dval_dx], dim=-1)
    if squeeze:
        return val[..., 0], dval[..., 0, :]
    return val, dval


def bicubic_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Catmull-Rom bicubic sampling (Keys, a = -0.5) of ``img`` at (..., 2).

    Coordinates clamp to the edge and every tap index clamps on its own
    (edge-replicated padding). Plain PyTorch on every device, as in the
    reference, which has no bicubic kernel.
    """
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    h, w, c = img.shape
    y = torch.clamp(coords[..., 0], 0.0, h - 1.0)
    x = torch.clamp(coords[..., 1], 0.0, w - 1.0)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    fy = y - y0
    fx = x - x0
    y0i = y0.long()
    x0i = x0.long()

    def cubic_weights(f):
        f2 = f * f
        f3 = f2 * f
        return (
            -0.5 * f3 + f2 - 0.5 * f,
            1.5 * f3 - 2.5 * f2 + 1.0,
            -1.5 * f3 + 2.0 * f2 + 0.5 * f,
            0.5 * f3 - 0.5 * f2,
        )

    wy = cubic_weights(fy)
    wx = cubic_weights(fx)
    flat = img.reshape(h * w, c)

    def take(dy, dx):
        yi = torch.clamp(y0i + dy, 0, h - 1)
        xi = torch.clamp(x0i + dx, 0, w - 1)
        return flat[yi * w + xi]

    out = torch.zeros(coords.shape[:-1] + (c,), dtype=img.dtype, device=img.device)
    for iy, dy in enumerate((-1, 0, 1, 2)):
        row = torch.zeros_like(out)
        for ix, dx in enumerate((-1, 0, 1, 2)):
            row = row + wx[ix][..., None] * take(dy, dx)
        out = out + wy[iy][..., None] * row
    return out[..., 0] if squeeze else out
