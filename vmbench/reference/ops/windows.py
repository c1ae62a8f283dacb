"""Separable window filters and the 3x3 median.

Port of ``videomorphing_tpu/ops/windows.py``. The 5-tap separable sums are
written as shifted-slice adds, not ``F.conv2d``: cuDNN would run them in
TF32 and in another summation order.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def gaussian_taps(size: int, sigma: float) -> tuple:
    """Normalized 1-D Gaussian taps of odd ``size`` as float32 values
    (the reference's ``_gaussian_np``)."""
    r = (size - 1) / 2.0
    x = np.arange(size, dtype=np.float64) - r
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return tuple(float(t) for t in (k / k.sum()).astype(np.float32))


def gaussian_kernel_1d(size: int, sigma: float, dtype=torch.float32, device=None) -> torch.Tensor:
    """Normalized 1-D Gaussian kernel of odd ``size``."""
    return torch.tensor(gaussian_taps(int(size), float(sigma)), dtype=dtype, device=device)


def edge_pad(x: torch.Tensor, pad_y, pad_x) -> torch.Tensor:
    """Edge-replicate ``x`` over its first two axes by ``(before, after)``."""
    h, w = x.shape[0], x.shape[1]
    iy = torch.clamp(torch.arange(-pad_y[0], h + pad_y[1], device=x.device), 0, h - 1)
    ix = torch.clamp(torch.arange(-pad_x[0], w + pad_x[1], device=x.device), 0, w - 1)
    return x[iy][:, ix]


def _taps_list(k) -> Sequence[float]:
    if isinstance(k, torch.Tensor):
        return [float(t) for t in k.detach().cpu().tolist()]
    return [float(t) for t in k]


def _filter_axis(x: torch.Tensor, taps: Sequence[float], axis: int, mode: str) -> torch.Tensor:
    size = len(taps)
    r = (size - 1) // 2
    n = x.shape[axis]
    if mode == "same_zero":
        shape = list(x.shape)
        shape[axis] = n + 2 * r
        xp = x.new_zeros(shape)
        xp.narrow(axis, r, n).copy_(x)
    elif mode == "same_edge":
        xp = edge_pad(x, (r, r), (0, 0)) if axis == 0 else edge_pad(x, (0, 0), (r, r))
    else:
        raise ValueError(f"unknown mode {mode!r}")
    out = None
    for t, kt in enumerate(taps):
        sl = xp.narrow(axis, t, n) * kt
        out = sl if out is None else out + sl
    return out


def separable_filter(x: torch.Tensor, ky, kx=None, mode: str = "same_zero") -> torch.Tensor:
    """Apply a separable filter ky (rows) then kx (cols) to (H, W, C) or (H, W).

    ``mode``: ``'same_zero'`` (zero padding) or ``'same_edge'`` (edge
    replication).
    """
    if kx is None:
        kx = ky
    return _filter_axis(_filter_axis(x, _taps_list(ky), 0, mode), _taps_list(kx), 1, mode)


def median3x3(x: torch.Tensor) -> torch.Tensor:
    """Per-channel 3x3 median of (H, W, ...) with edge-replicated borders.

    Paeth's 19-compare-exchange median-of-9 network, as in the reference.
    """
    p = edge_pad(x, (1, 1), (1, 1))
    h, w = x.shape[0], x.shape[1]
    n = [p[dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)]

    def ex(i, j):
        lo = torch.minimum(n[i], n[j])
        n[j] = torch.maximum(n[i], n[j])
        n[i] = lo

    for i, j in (
        (1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2), (4, 5),
        (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7),
        (4, 2), (6, 4), (4, 2),
    ):
        ex(i, j)
    return n[4]
