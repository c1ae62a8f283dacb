"""Kernels 1 and 2: the solver's sweep gradient and sweep energy.

Source: ``csrc/sweep.cu`` (``vm_sweep_grad``, ``vm_sweep_energy``; one
template ``sweep_kernel<R, WITH_GRAD>``).

- ``sweep_grad`` replaces ``videomorphing_tpu/pallas/sweep.py:293``
  (``_build_grad_call``, driven by ``fused_value_grad_precond_pack``);
- ``sweep_energy`` replaces ``videomorphing_tpu/pallas/sweep.py:502``
  (``_build_energy_call``, driven by ``fused_total_energy_pack``).

Both evaluate the halfway-domain energy on the warps linearized around
``v_lin``: ``a0 = w0 - dw0.(v - v_lin)``, ``a1 = w1 + dw1.(v - v_lin)``.
They are bound by operations on the H100 (~29 window sums and ~60 maps per
pixel and channel); each 16 x 16 tile is staged through shared memory with
a halo of twice the window radius, so all window sums read shared memory,
and the inputs are the warp kernel's plane stack as it comes, with no pack.
Energy partials reduce in a fixed order (no float atomics), so reruns are
bitwise identical.

Dispatch: a CPU tensor runs the plain PyTorch version (``linearized_warps``
+ ``value_grad_precond_planes`` / ``total_energy_planes``); a CUDA tensor
launches the kernel or raises. Launch counts: ``sweep_grad.launches`` and
``sweep_energy.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from videomorphing_tpu_torch.config import MorphParams
from videomorphing_tpu_torch.kernels import build
from videomorphing_tpu_torch.kernels.warp import check_cuda_input, on_cuda, stream_of
from videomorphing_tpu_torch.ops.windows import gaussian_taps

TILE = 16  # output tile side of sweep_kernel (csrc/sweep.cu: T)
MAX_RADIUS = 3  # window radii instantiated in csrc/sweep.cu


class _Scalars(ctypes.Structure):
    """Mirror of ``VmSweepScalars`` in ``csrc/sweep.cu``."""

    _fields_ = [
        ("taps", ctypes.c_float * 8),
        ("radius", ctypes.c_int),
        ("use_luminance", ctypes.c_int),
        ("c1", ctypes.c_float),
        ("c2", ctypes.c_float),
        ("scale", ctypes.c_float),
        ("lam_n", ctypes.c_float),
        ("gui_n", ctypes.c_float),
        ("gtc_n", ctypes.c_float),
        ("psim_n", ctypes.c_float),
        ("ptps", ctypes.c_float),
        ("pquad_n", ctypes.c_float),
        ("eps_n", ctypes.c_float),
        ("gamma_ui", ctypes.c_float),
        ("beta_tc", ctypes.c_float),
        ("lambda_tps", ctypes.c_float),
        ("h", ctypes.c_int),
        ("w", ctypes.c_int),
        ("C", ctypes.c_int),
    ]


def _scalars(p: MorphParams, h: int, w: int, c: int) -> _Scalars:
    """Kernel constants, each computed in double and rounded once to
    float32, as the reference's weakly typed Python constants are."""
    taps = gaussian_taps(int(p.ssim_window), float(p.ssim_sigma))
    r = (len(taps) - 1) // 2
    if not 1 <= r <= MAX_RADIUS:
        raise ValueError(f"sweep kernels support ssim_window 3, 5 or 7, got {p.ssim_window}")
    npix = h * w
    s = _Scalars()
    for i, t in enumerate(taps):
        s.taps[i] = t
    s.radius = r
    s.use_luminance = int(bool(p.ssim_use_luminance))
    s.c1, s.c2 = p.ssim_c1, p.ssim_c2
    s.scale = -1.0 / (npix * c)
    s.lam_n = p.lambda_tps / npix
    s.gui_n = 2.0 * p.gamma_ui / npix
    s.gtc_n = 2.0 * p.beta_tc / npix
    s.psim_n = 2.0 / (npix * c)
    s.ptps = p.lambda_tps / npix * 25.0
    s.pquad_n = 2.0 / npix
    s.eps_n = p.precond_eps / npix
    s.gamma_ui, s.beta_tc, s.lambda_tps = p.gamma_ui, p.beta_tc, p.lambda_tps
    s.h, s.w, s.C = h, w, c
    return s


def _check(planes, v_lin, v, data):
    c6, h, w = planes.shape
    if c6 % 6:
        raise ValueError(f"planes: expected (6C, H, W), got {tuple(planes.shape)}")
    check_cuda_input(planes, "planes")
    check_cuda_input(v_lin, "v_lin", (h, w, 2))
    check_cuda_input(v, "v", (h, w, 2))
    check_cuda_input(data.ui_w, "ui_w", (h, w, 1))
    check_cuda_input(data.ui_v, "ui_v", (h, w, 2))
    check_cuda_input(data.tc_w, "tc_w", (h, w, 1))
    check_cuda_input(data.tc_v, "tc_v", (h, w, 2))
    return h, w, c6 // 6


def _n_blocks(h: int, w: int) -> int:
    return -(-h // TILE) * -(-w // TILE)


def sweep_grad_plain(planes, v_lin, v, data, p: MorphParams):
    """Plain version of kernel 1."""
    from videomorphing_tpu_torch.kernels.warp import bundle_from_planes
    from videomorphing_tpu_torch.solver.descent import (
        WarpBundle,
        linearized_warps,
        value_grad_precond_planes,
    )

    w0, dw0, w1, dw1 = bundle_from_planes(planes)
    w0e, w1e = linearized_warps(WarpBundle(v_lin, w0, dw0, w1, dw1), v)
    return value_grad_precond_planes(w0e, dw0, w1e, dw1, v, data, p)


def sweep_energy_plain(planes, v_lin, v, data, p: MorphParams):
    """Plain version of kernel 2."""
    from videomorphing_tpu_torch.kernels.warp import bundle_from_planes
    from videomorphing_tpu_torch.solver.descent import (
        WarpBundle,
        linearized_warps,
        total_energy_planes,
    )

    w0, dw0, w1, dw1 = bundle_from_planes(planes)
    w0e, w1e = linearized_warps(WarpBundle(v_lin, w0, dw0, w1, dw1), v)
    return total_energy_planes(w0e, w1e, v, data, p)


def sweep_grad(planes, v_lin, v, data, p: MorphParams):
    """``(energy, grad, precond)`` at ``v`` on the warps linearized around
    ``v_lin``; ``planes`` is the (6C, H, W) stack of ``halfway_warp``.
    ``energy`` is a 0-d tensor on the input's device."""
    if not on_cuda(planes, v_lin, v, data.ui_w, data.ui_v, data.tc_w, data.tc_v):
        return sweep_grad_plain(planes, v_lin, v, data, p)
    h, w, c = _check(planes, v_lin, v, data)
    s = _scalars(p, h, w, c)
    dev = v.device
    grad = torch.empty((h, w, 2), dtype=torch.float32, device=dev)
    precond = torch.empty((h, w, 2), dtype=torch.float32, device=dev)
    partials = torch.empty((_n_blocks(h, w), 4), dtype=torch.float32, device=dev)
    out = torch.empty((5,), dtype=torch.float32, device=dev)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.vm_sweep_grad(
            planes.data_ptr(), v_lin.data_ptr(), v.data_ptr(),
            data.ui_w.data_ptr(), data.ui_v.data_ptr(),
            data.tc_w.data_ptr(), data.tc_v.data_ptr(),
            grad.data_ptr(), precond.data_ptr(), partials.data_ptr(), out.data_ptr(),
            ctypes.addressof(s), stream_of(v),
        )
    build.check(err, "vm_sweep_grad")
    sweep_grad.launches += 1
    return out[4], grad, precond


sweep_grad.launches = 0


def sweep_energy(planes, v_lin, v, data, p: MorphParams):
    """Total energy (0-d tensor) at ``v`` on the linearized warps."""
    if not on_cuda(planes, v_lin, v, data.ui_w, data.ui_v, data.tc_w, data.tc_v):
        return sweep_energy_plain(planes, v_lin, v, data, p)
    h, w, c = _check(planes, v_lin, v, data)
    s = _scalars(p, h, w, c)
    dev = v.device
    partials = torch.empty((_n_blocks(h, w), 4), dtype=torch.float32, device=dev)
    out = torch.empty((5,), dtype=torch.float32, device=dev)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.vm_sweep_energy(
            planes.data_ptr(), v_lin.data_ptr(), v.data_ptr(),
            data.ui_w.data_ptr(), data.ui_v.data_ptr(),
            data.tc_w.data_ptr(), data.tc_v.data_ptr(),
            partials.data_ptr(), out.data_ptr(),
            ctypes.addressof(s), stream_of(v),
        )
    build.check(err, "vm_sweep_energy")
    sweep_energy.launches += 1
    return out[4]


sweep_energy.launches = 0
