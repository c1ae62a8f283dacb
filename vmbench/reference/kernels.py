"""The four kernels' arithmetic in plain PyTorch, on whatever device the
tensors lie: the sweep gradient and energy (kernels 1-2), the halfway warp
(kernel 3) and the bilinear sampler (kernel 4).

A frozen copy of the program's plain versions (float32 only). Every call
runs the plain operations; nothing here launches or loads a hand-written
kernel.
"""

from __future__ import annotations

import torch

from vmbench.reference.config import MorphParams
from vmbench.reference.ops import resample


def planes_from_bundle(w0, dw0, w1, dw1) -> torch.Tensor:
    """(6C, H, W) stack: w0 (C), w1 (C), dw0 (y, x per channel), dw1."""
    h, w, c = w0.shape
    return torch.cat(
        [
            w0.permute(2, 0, 1),
            w1.permute(2, 0, 1),
            dw0.permute(2, 3, 0, 1).reshape(2 * c, h, w),
            dw1.permute(2, 3, 0, 1).reshape(2 * c, h, w),
        ],
        dim=0,
    ).contiguous()


def bundle_from_planes(planes: torch.Tensor):
    """Inverse of :func:`planes_from_bundle`: (w0, dw0, w1, dw1)."""
    c = planes.shape[0] // 6
    h, w = planes.shape[1], planes.shape[2]
    w0 = planes[0:c].permute(1, 2, 0)
    w1 = planes[c : 2 * c].permute(1, 2, 0)
    dw0 = planes[2 * c : 4 * c].reshape(c, 2, h, w).permute(2, 3, 0, 1)
    dw1 = planes[4 * c : 6 * c].reshape(c, 2, h, w).permute(2, 3, 0, 1)
    return w0, dw0, w1, dw1


def halfway_warp(i0: torch.Tensor, i1: torch.Tensor, v: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Both halfway warps ``I0(p - v)``, ``I1(p + v)`` and their interpolant
    derivatives as one (6C, H, W) float32 plane stack."""
    if dtype != torch.float32:
        raise ValueError("the reference computes float32 planes only")
    g = resample.grid_coords(i0.shape[0], i0.shape[1], dtype=v.dtype, device=v.device)
    w0, dw0 = resample.bilinear_sample_with_grad(i0, g - v)
    w1, dw1 = resample.bilinear_sample_with_grad(i1, g + v)
    return planes_from_bundle(w0, dw0, w1, dw1)


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear edge-clamp values of ``img`` (H, W, C) or (H, W) at
    ``coords`` (..., 2) in (y, x) -> (..., C) or (...)."""
    squeeze = img.dim() == 2
    img3 = img[..., None] if squeeze else img
    lead = tuple(coords.shape[:-1])
    out = resample.bilinear_sample(img3, coords.reshape(1, -1, 2)).reshape(lead + (img3.shape[-1],))
    return out[..., 0] if squeeze else out


def bilinear_sample_batched(imgs: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """``imgs`` (n, H, W, C) each at its own ``coords`` (n, Ho, Wo, 2)."""
    return resample.bilinear_sample_batched(imgs, coords)


def pack_dtype(p: MorphParams) -> torch.dtype:
    """float32, whatever ``p.pack_dtype`` says: the reference is the float32
    yardstick, also of a program run with a lower-precision pack."""
    return torch.float32


def quantize_v_lin(v: torch.Tensor, p: MorphParams) -> torch.Tensor:
    return v


def pack_maps(data, dtype: torch.dtype):
    return data


def sweep_grad(planes, v_lin, v, data, p: MorphParams):
    """(energy, grad, precond) at ``v`` on the warps linearized around ``v_lin``."""
    from vmbench.reference.solver.descent import WarpBundle, linearized_warps, value_grad_precond_planes

    w0, dw0, w1, dw1 = bundle_from_planes(planes)
    w0e, w1e = linearized_warps(WarpBundle(v_lin, w0, dw0, w1, dw1), v)
    return value_grad_precond_planes(w0e, dw0, w1e, dw1, v, data, p)


def sweep_energy(planes, v_lin, v, data, p: MorphParams):
    """Total energy (0-d tensor) at ``v`` on the linearized warps."""
    from vmbench.reference.solver.descent import WarpBundle, linearized_warps, total_energy_planes

    w0, dw0, w1, dw1 = bundle_from_planes(planes)
    w0e, w1e = linearized_warps(WarpBundle(v_lin, w0, dw0, w1, dw1), v)
    return total_energy_planes(w0e, w1e, v, data, p)
