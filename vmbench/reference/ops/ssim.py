"""SSIM-style structural dissimilarity with analytic gradients.

Port of ``videomorphing_tpu/ops/ssim.py`` (the data term E_SIM of [TOG14]
section 3.1). Windowed sums use zero padding plus the normalization map
``n = wsum(1)``, so border pixels get unbiased statistics. The analytic
backward here is the plain version of what the sweep kernel
(``csrc/sweep.cu``) fuses into one pass. ``valid=`` (an (H, W, 1) mask of
in-frame pixels) serves the row-sharded solve: a block extended by zero
rows beyond the frame plus this mask gives the frame's window sums.
``inv_n_dtype=torch.bfloat16`` rounds ``1/n`` to bfloat16 before use, as
the reference's bf16 sweep pack stores it (``MorphParams.pack_dtype``); all
else stays float32.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from vmbench.reference.ops.windows import gaussian_taps, separable_filter


def _wsum(x: torch.Tensor, taps) -> torch.Tensor:
    return separable_filter(x, taps, taps, mode="same_zero")


def _rounded(inv_n: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``inv_n`` rounded to ``dtype`` (nearest even) and back."""
    return inv_n if dtype == inv_n.dtype else inv_n.to(dtype).to(inv_n.dtype)


def ssim_parts(
    w0: torch.Tensor, w1: torch.Tensor, window: int = 5, sigma: float = 1.0, valid=None, *,
    inv_n_dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.Tensor]:
    """Windowed SSIM statistics of two (H, W, C) images; with ``valid``
    (H, W, 1) the images are masked to it and ``n`` is its window sum;
    ``1/n`` is rounded to ``inv_n_dtype``."""
    k = gaussian_taps(int(window), float(sigma))
    if valid is None:
        valid = w0.new_ones(w0.shape[:2] + (1,))
    else:
        w0 = w0 * valid
        w1 = w1 * valid
    n = _wsum(valid, k)
    inv_n = _rounded(torch.where(n > 1e-8, 1.0 / torch.clamp(n, min=1e-8), torch.zeros_like(n)), inv_n_dtype)
    mu0 = _wsum(w0, k) * inv_n
    mu1 = _wsum(w1, k) * inv_n
    e00 = _wsum(w0 * w0, k) * inv_n
    e11 = _wsum(w1 * w1, k) * inv_n
    e01 = _wsum(w0 * w1, k) * inv_n
    var0 = torch.clamp(e00 - mu0 * mu0, min=0.0)
    var1 = torch.clamp(e11 - mu1 * mu1, min=0.0)
    cov = e01 - mu0 * mu1
    return dict(mu0=mu0, mu1=mu1, var0=var0, var1=var1, cov=cov, n=n)


def dssim_map(
    w0: torch.Tensor,
    w1: torch.Tensor,
    window: int = 5,
    sigma: float = 1.0,
    c1: float = 1e-4,
    c2: float = 9e-4,
    use_luminance: bool = True,
    *,
    inv_n_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Per-pixel structural dissimilarity in [0, 2], channel-averaged (H, W)."""
    parts = ssim_parts(w0, w1, window, sigma, inv_n_dtype=inv_n_dtype)
    a2 = 2.0 * parts["cov"] + c2
    b2 = parts["var0"] + parts["var1"] + c2
    if use_luminance:
        a1 = 2.0 * parts["mu0"] * parts["mu1"] + c1
        b1 = parts["mu0"] ** 2 + parts["mu1"] ** 2 + c1
        s = (a1 * a2) / (b1 * b2)
    else:
        s = a2 / b2
    return torch.mean(1.0 - s, dim=-1)


class DssimGradBundle(NamedTuple):
    energy: torch.Tensor  # scalar E = mean_{p,c}(1 - s)
    g0: torch.Tensor      # (H, W, C) dE/dw0
    g1: torch.Tensor      # (H, W, C) dE/dw1
    dmap: torch.Tensor    # (H, W) channel-mean dissimilarity
    b2: torch.Tensor      # (H, W, C) var0 + var1 + c2


def dssim_grad_bundle(
    w0: torch.Tensor,
    w1: torch.Tensor,
    window: int = 5,
    sigma: float = 1.0,
    c1: float = 1e-4,
    c2: float = 9e-4,
    use_luminance: bool = True,
    valid=None,
    *,
    inv_n_dtype: torch.dtype = torch.float32,
) -> DssimGradBundle:
    """Value, analytic gradients and curvature scale in one pass.

    With coefficient maps c_mu = dS/dmu, c_var = dS/dvar, c_cov = dS/dcov,
    the transpose of the (symmetric) window gives

        dE/dw0 = wsum((c_mu - 2 mu0 c_var - mu1 c_cov)/n)
                 + 2 w0 wsum(c_var/n) + w1 wsum(c_cov/n),

    and symmetrically for w1. With ``valid``, window centres outside it add
    nothing (their 1/n is zeroed) and the energy and map count only valid
    pixels, normalized by the full H W C as the reference's.
    """
    h, w, c = w0.shape
    k = gaussian_taps(int(window), float(sigma))
    parts = ssim_parts(w0, w1, window, sigma, valid, inv_n_dtype=inv_n_dtype)
    if valid is not None:
        w0 = w0 * valid
        w1 = w1 * valid
    mu0, mu1 = parts["mu0"], parts["mu1"]
    var0, var1, cov, n = parts["var0"], parts["var1"], parts["cov"], parts["n"]

    a2 = 2.0 * cov + c2
    b2 = var0 + var1 + c2
    if use_luminance:
        a1 = 2.0 * mu0 * mu1 + c1
        b1 = mu0 ** 2 + mu1 ** 2 + c1
    else:
        a1 = torch.ones_like(a2)
        b1 = torch.ones_like(a2)
    denom = b1 * b2
    s = (a1 * a2) / denom
    vmask = 1.0 if valid is None else valid
    energy = torch.mean((1.0 - s) * vmask)

    ds_da2 = a1 / denom
    ds_db2 = -s / b2
    if use_luminance:
        ds_da1 = a2 / denom
        ds_db1 = -s / b1
        c_mu0 = ds_da1 * 2.0 * mu1 + ds_db1 * 2.0 * mu0
        c_mu1 = ds_da1 * 2.0 * mu0 + ds_db1 * 2.0 * mu1
    else:
        c_mu0 = torch.zeros_like(s)
        c_mu1 = torch.zeros_like(s)
    c_var = ds_db2
    c_cov = ds_da2 * 2.0

    scale = -1.0 / (h * w * c)
    if valid is None:
        inv_n = _rounded(1.0 / n, inv_n_dtype)
    else:
        inv_n = _rounded(torch.where(n > 1e-8, 1.0 / torch.clamp(n, min=1e-8), torch.zeros_like(n)),
                         inv_n_dtype) * valid

    def grad_one(c_mu_a, mu_a, mu_b, w_a, w_b):
        t0 = _wsum(scale * (c_mu_a - 2.0 * mu_a * c_var - mu_b * c_cov) * inv_n, k)
        t1 = _wsum(scale * c_var * inv_n, k)
        t2 = _wsum(scale * c_cov * inv_n, k)
        return t0 + 2.0 * w_a * t1 + w_b * t2

    g0 = grad_one(c_mu0, mu0, mu1, w0, w1)
    g1 = grad_one(c_mu1, mu1, mu0, w1, w0)
    dmap = torch.mean((1.0 - s) * vmask, dim=-1)
    return DssimGradBundle(energy, g0, g1, dmap, b2)
