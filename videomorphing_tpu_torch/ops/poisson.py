"""Screened-Poisson solves (matmul DCT) and pull-push extension.

Port of ``videomorphing_tpu/ops/poisson.py``. The DCT-II is a product with
the orthonormal cosine basis, as in the reference, so the two packages
compute the same transform; ``torch.matmul`` runs it in full float32
(TF32 is off, ``device.py``). An FFT form is later performance work.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from videomorphing_tpu_torch.graphs import constant_cache
from videomorphing_tpu_torch.ops.pyramid import downsample_2x, upsample_2x


@constant_cache(maxsize=32)
def _dct_mat(n: int, dtype, device) -> torch.Tensor:
    """Orthonormal DCT-II basis C[k, m] = s_k sqrt(2/n) cos(pi (m+.5) k / n),
    built in float64 and rounded once."""
    k = np.arange(n, dtype=np.float64)[:, None]
    m = np.arange(n, dtype=np.float64)[None, :]
    c = np.cos(np.pi * (m + 0.5) * k / n) * np.sqrt(2.0 / n)
    c[0] *= np.sqrt(0.5)
    return torch.from_numpy(c.astype(np.float32)).to(device=device, dtype=dtype)


def _dct_apply(x: torch.Tensor, axis: int, inverse: bool) -> torch.Tensor:
    c = _dct_mat(x.shape[axis], x.dtype, x.device)
    mat = c.T if inverse else c
    y = torch.tensordot(mat, x, dims=([1], [axis]))
    return torch.movedim(y, 0, axis)


def dct2(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal DCT-II over the first two axes of (H, W, ...)."""
    return _dct_apply(_dct_apply(x, 0, False), 1, False)


def idct2(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`dct2` (the basis is orthogonal: inverse = C^T)."""
    return _dct_apply(_dct_apply(x, 0, True), 1, True)


def _neg_laplace_eigs(h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Eigenvalues of -Laplacian (5-point, Neumann) under DCT-II, (H, W)."""
    ky = torch.arange(h, dtype=dtype, device=device)
    kx = torch.arange(w, dtype=dtype, device=device)
    ly = 2.0 - 2.0 * torch.cos(math.pi * ky / h)
    lx = 2.0 - 2.0 * torch.cos(math.pi * kx / w)
    return ly[:, None] + lx[None, :]


def _expand_eigs(lam: torch.Tensor, ndim: int) -> torch.Tensor:
    return lam.reshape(lam.shape + (1,) * (ndim - 2))


def screened_poisson_dct(target: torch.Tensor, alpha: float, mu: float) -> torch.Tensor:
    """Solve ``(alpha*I - mu*Laplacian) x = alpha * target`` (Neumann)."""
    h, w = target.shape[0], target.shape[1]
    lam = _expand_eigs(_neg_laplace_eigs(h, w, target.dtype, target.device), target.dim())
    t_hat = dct2(target)
    x_hat = (alpha * t_hat) / (alpha + mu * lam)
    return idct2(x_hat)


def screened_solve(rhs: torch.Tensor, lam: float) -> torch.Tensor:
    """Solve ``(lam*I - Laplacian) x = rhs`` with Neumann boundaries."""
    h, w = rhs.shape[0], rhs.shape[1]
    eigs = _expand_eigs(_neg_laplace_eigs(h, w, rhs.dtype, rhs.device), rhs.dim())
    return idct2(dct2(rhs) / (lam + eigs))


def poisson_solve_dct(rhs: torch.Tensor, mean_value=0.0) -> torch.Tensor:
    """Solve ``Laplacian x = rhs`` (Neumann) with the free mean pinned to
    ``mean_value`` (a number or a tensor broadcast over the channels)."""
    h, w = rhs.shape[0], rhs.shape[1]
    lam = _expand_eigs(_neg_laplace_eigs(h, w, rhs.dtype, rhs.device), rhs.dim())
    r_hat = dct2(rhs)
    zero = lam == 0.0
    x_hat = torch.where(zero, torch.zeros_like(r_hat), r_hat / torch.where(zero, torch.ones_like(lam), -lam))
    x = idct2(x_hat)
    return x - torch.mean(x, dim=(0, 1), keepdim=True) + mean_value


def divergence(gy: torch.Tensor, gx: torch.Tensor) -> torch.Tensor:
    """Backward-difference divergence matching forward-difference gradients."""
    dy = gy - torch.roll(gy, 1, dims=0)
    dy[0] = gy[0]
    dx = gx - torch.roll(gx, 1, dims=1)
    dx[:, 0] = gx[:, 0]
    return dy + dx


def forward_gradients(x: torch.Tensor):
    """Forward differences with zero at the far edge (adjoint of divergence)."""
    gy = torch.roll(x, -1, dims=0) - x
    gy[-1] = 0.0
    gx = torch.roll(x, -1, dims=1) - x
    gx[:, -1] = 0.0
    return gy, gx


def pull_push_extend(
    img: torch.Tensor,
    weight: torch.Tensor,
    n_levels: int = 0,
    jacobi_iters: int = 0,
) -> torch.Tensor:
    """Membrane-like extension of ``img`` (H, W, C) into regions where
    ``weight`` (H, W) is ~0: multiscale pull-push on premultiplied colours,
    optionally relaxed by masked Jacobi sweeps."""
    h, w = img.shape[0], img.shape[1]
    if n_levels <= 0:
        n_levels = 1
        hh, ww = h, w
        while min(hh, ww) > 4 and n_levels < 12:
            hh = -(-hh // 2)
            ww = -(-ww // 2)
            n_levels += 1

    eps = 1e-6
    wgt = torch.clamp(weight, 0.0, 1.0)[..., None]

    def rec(cw, ww_, depth):
        if depth == n_levels - 1 or min(cw.shape[0], cw.shape[1]) <= 4:
            return cw / torch.clamp(ww_, min=eps)
        cw2 = downsample_2x(cw)
        ww2 = downsample_2x(ww_)
        filled_coarse = rec(cw2, ww2, depth + 1)
        up = upsample_2x(filled_coarse, (cw.shape[0], cw.shape[1]))
        wc = torch.clamp(ww_, 0.0, 1.0)
        return wc * (cw / torch.clamp(ww_, min=eps)) + (1.0 - wc) * up

    out = rec(img * wgt, wgt, 0)
    out = wgt * img + (1.0 - wgt) * out

    if jacobi_iters > 0:
        hole = (1.0 - wgt) > 0.5
        for _ in range(jacobi_iters):
            nb = (
                torch.roll(out, 1, 0) + torch.roll(out, -1, 0)
                + torch.roll(out, 1, 1) + torch.roll(out, -1, 1)
            ) * 0.25
            out = torch.where(hole, nb, out)
    return out
