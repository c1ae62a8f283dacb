"""Kernels 3 and 4: the halfway warp and the bilinear sampler.

Source: ``csrc/warp.cu`` (``vm_halfway_warp``, ``vm_bilinear_sample``).

- ``halfway_warp`` replaces ``videomorphing_tpu/pallas/warp.py:206``
  (``_build_warp_call``, driven by ``fused_warp_planes``);
- ``bilinear_sample`` replaces ``videomorphing_tpu/pallas/warp.py:311``
  (``_build_sample_call``, driven by ``fused_sample``).

Both are bound by memory on the H100 (4 taps x C reads per image, one write
per output value). The TPU kernels enumerate per-tile residual offsets over
row-phase copies and fall back to an XLA gather when a tile's field is too
wild; on Hopper a gather is native, so each CUDA kernel is one thread per
output pixel with no fit test and no fallback.

Dispatch: a CPU tensor runs the plain PyTorch version; a CUDA tensor
launches the kernel or raises. Each wrapper counts its launches in a plain
integer attribute (``halfway_warp.launches``, ``bilinear_sample.launches``).
"""

from __future__ import annotations

import torch

from videomorphing_tpu_torch.kernels import build
from videomorphing_tpu_torch.ops import resample


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on one CUDA device, False when all are on
    the CPU; raises on anything else."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return True


def check_cuda_input(t: torch.Tensor, name: str, shape=None) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


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
    """Inverse of :func:`planes_from_bundle`: (w0, dw0, w1, dw1) in the
    (H, W, C) / (H, W, C, 2) layouts."""
    c = planes.shape[0] // 6
    h, w = planes.shape[1], planes.shape[2]
    w0 = planes[0:c].permute(1, 2, 0)
    w1 = planes[c : 2 * c].permute(1, 2, 0)
    dw0 = planes[2 * c : 4 * c].reshape(c, 2, h, w).permute(2, 3, 0, 1)
    dw1 = planes[4 * c : 6 * c].reshape(c, 2, h, w).permute(2, 3, 0, 1)
    return w0, dw0, w1, dw1


def halfway_warp_plain(i0: torch.Tensor, i1: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 3: ``bilinear_sample_with_grad`` at g -/+ v."""
    g = resample.grid_coords(i0.shape[0], i0.shape[1], dtype=v.dtype, device=v.device)
    w0, dw0 = resample.bilinear_sample_with_grad(i0, g - v)
    w1, dw1 = resample.bilinear_sample_with_grad(i1, g + v)
    return planes_from_bundle(w0, dw0, w1, dw1)


def halfway_warp(i0: torch.Tensor, i1: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Both halfway warps ``I0(p - v)``, ``I1(p + v)`` and their exact
    interpolant derivatives as one (6C, H, W) plane stack, in the order of
    the reference's ``fused_warp_planes``; the sweep kernels read it as is."""
    if not on_cuda(i0, i1, v):
        return halfway_warp_plain(i0, i1, v)
    h, w, c = i0.shape
    check_cuda_input(i0, "i0")
    check_cuda_input(i1, "i1", (h, w, c))
    check_cuda_input(v, "v", (h, w, 2))
    out = torch.empty((6 * c, h, w), dtype=torch.float32, device=v.device)
    lib = build.load()
    with torch.cuda.device(v.device):
        err = lib.vm_halfway_warp(
            i0.data_ptr(), i1.data_ptr(), v.data_ptr(), out.data_ptr(), h, w, c, stream_of(v)
        )
    build.check(err, "vm_halfway_warp")
    halfway_warp.launches += 1
    return out


halfway_warp.launches = 0


def bilinear_sample_plain(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 4."""
    return resample.bilinear_sample(img, coords)


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear edge-clamp values of ``img`` (H, W, C) at ``coords``
    (Ho, Wo, 2) in (y, x) -> (Ho, Wo, C)."""
    if not on_cuda(img, coords):
        return bilinear_sample_plain(img, coords)
    if img.dim() != 3 or coords.dim() != 3 or coords.shape[-1] != 2:
        raise ValueError(f"expected (H, W, C) and (Ho, Wo, 2), got {tuple(img.shape)}, {tuple(coords.shape)}")
    h, w, c = img.shape
    ho, wo = coords.shape[0], coords.shape[1]
    check_cuda_input(img, "img")
    check_cuda_input(coords, "coords")
    out = torch.empty((ho, wo, c), dtype=torch.float32, device=img.device)
    lib = build.load()
    with torch.cuda.device(img.device):
        err = lib.vm_bilinear_sample(
            img.data_ptr(), coords.data_ptr(), out.data_ptr(), h, w, c, ho, wo, stream_of(img)
        )
    build.check(err, "vm_bilinear_sample")
    bilinear_sample.launches += 1
    return out


bilinear_sample.launches = 0
