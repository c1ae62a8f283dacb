"""Gaussian pyramids and field up/downsampling.

Port of ``videomorphing_tpu/ops/pyramid.py``. ``pyr[0]`` is the finest
(full-resolution) level, ``pyr[-1]`` the coarsest.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

from videomorphing_tpu_torch.ops.windows import edge_pad, gaussian_taps


def auto_n_levels(h: int, w: int, min_size: int = 32, max_levels: int = 16) -> int:
    """Number of pyramid levels so the coarsest lands in [min_size, 2*min_size)."""
    n = 1
    while min(h, w) >= min_size * 2 and n < max_levels:
        h = -(-h // 2)
        w = -(-w // 2)
        n += 1
    return n


def pyramid_shapes(h: int, w: int, n_levels: int) -> List[Tuple[int, int]]:
    """Per-level (H, W), finest first; the next level is ceil(prev / 2)."""
    shapes = [(h, w)]
    for _ in range(n_levels - 1):
        h = -(-h // 2)
        w = -(-w // 2)
        shapes.append((h, w))
    return shapes


def downsample_2x(img: torch.Tensor, sigma: float = 0.85) -> torch.Tensor:
    """Gaussian blur (edge-replicated) + 2x decimation of (H, W, ...).

    Polyphase form of the reference: the blurred value is computed at even
    positions only, as 5 strided slices times taps per axis. Output shape
    is ceil(H/2) x ceil(W/2).
    """
    taps = gaussian_taps(5, float(sigma))
    r = 2
    h, w = img.shape[0], img.shape[1]
    ho, wo = -(-h // 2), -(-w // 2)
    xp = edge_pad(img, (r, r + (2 * ho - h)), (0, 0))
    rows = None
    for t, kt in enumerate(taps):
        sl = kt * xp[t : t + 2 * ho : 2]
        rows = sl if rows is None else rows + sl
    xp2 = edge_pad(rows, (0, 0), (r, r + (2 * wo - w)))
    out = None
    for t, kt in enumerate(taps):
        sl = kt * xp2[:, t : t + 2 * wo : 2]
        out = sl if out is None else out + sl
    return out


@functools.lru_cache(maxsize=64)
def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) linear-resize weights, built as ``jax.image.resize``
    builds them (``scale_and_translate`` with the triangle kernel and
    antialiasing): half-pixel centres, the kernel widened by the inverse
    scale when shrinking, edge taps renormalized."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float64)[:, None]) / kernel_scale
    wts = np.maximum(0.0, 1.0 - x)
    total = wts.sum(axis=0, keepdims=True)
    ok = np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps)
    wts = np.where(ok, wts / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    wts = np.where(inside[None, :], wts, 0.0)
    return torch.from_numpy(wts.astype(np.float32)).to(device)


def _resize_axis(x: torch.Tensor, axis: int, n_out: int) -> torch.Tensor:
    n_in = x.shape[axis]
    if n_out == n_in:
        return x
    wts = _resize_weights(n_in, int(n_out), x.device).to(x.dtype)
    return torch.movedim(torch.tensordot(wts, x, dims=([0], [axis])), 0, axis)


def resize_bilinear(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(img, out_hw + img.shape[2:], "bilinear")`` for
    (H, W, ...): one weight-matrix product per axis (rows, then columns)."""
    return _resize_axis(_resize_axis(img, 0, int(out_hw[0])), 1, int(out_hw[1]))


def upsample_2x(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear upsample of (H, W, ...) to ``out_hw`` (roughly 2x)."""
    return resize_bilinear(img, out_hw)


def upsample_field_2x(v: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Upsample a displacement field one level finer and rescale its values
    by the exact per-axis factor (ceil-division level shapes)."""
    h, w = v.shape[0], v.shape[1]
    oh, ow = out_hw
    up = upsample_2x(v, out_hw)
    scale = torch.tensor([oh / h, ow / w], dtype=v.dtype, device=v.device)
    return up * scale


def gaussian_pyramid(img: torch.Tensor, n_levels: int, sigma: float = 0.85) -> List[torch.Tensor]:
    """Gaussian pyramid, finest first; ``n_levels`` total."""
    pyr = [img]
    for _ in range(n_levels - 1):
        pyr.append(downsample_2x(pyr[-1], sigma=sigma))
    return pyr


def downsample_to(img: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Anti-aliased resize of (H, W, ...) to a smaller (H, W): 2x Gaussian
    decimations while both sides stay above twice the target (at most 17),
    then one bilinear resize."""
    steps = 0
    while img.shape[0] > 2 * hw[0] and img.shape[1] > 2 * hw[1]:
        img = downsample_2x(img)
        steps += 1
        if steps > 16:
            break
    return resize_bilinear(img, hw)
