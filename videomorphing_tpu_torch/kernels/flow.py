"""Kernel 5: one Horn-Schunck Jacobi sweep of a batch of flows.

Source: ``csrc/flow.cu`` (``vm_hs_sweep``). It replaces no TPU kernel: the
reference's ``_hs_level`` (``videomorphing_tpu/video/flow.py``) is plain
``jnp``. ``video.flow._hs_level`` runs ``flow_iters`` sweeps a warp; in eager
PyTorch each is about 19 launches and their temporaries, here one launch
that reads each input once and writes the new flow (bound by bytes, 40 a
site).

Dispatch: a CPU tensor runs the plain PyTorch version; a CUDA tensor
launches the kernel or raises. ``hs_sweep.launches`` counts the launches.
"""

from __future__ import annotations

import torch

from videomorphing_tpu_torch.kernels import build
from videomorphing_tpu_torch.kernels.warp import check_cuda_input, on_cuda, stream_of
from videomorphing_tpu_torch.ops.windows import edge_shifts

MAX_ROWS = 65535  # the launch grid's y extent: one grid row per image row


def hs_sweep_plain(ut, u_w, it, ix, iy, denom) -> torch.Tensor:
    """Plain version of kernel 5: the Jacobi update of the flow ``ut``
    (H, W, ..., 2) from its edge-replicated 4-neighbour average, the data
    term linearized at ``u_w`` (``it``, ``ix``, ``iy``: (H, W, ...)) and
    ``denom = alpha^2 + ix^2 + iy^2``. Both flow components share each
    stencil operation."""
    up, dn, lf, rt = edge_shifts(ut)
    ua = 0.25 * (up + dn + lf + rt)
    diff = ua - u_w
    resid = (it + ix * diff[..., 1] + iy * diff[..., 0]) / denom
    return ua - torch.stack([iy * resid, ix * resid], -1)


def hs_sweep(ut, u_w, it, ix, iy, denom, out) -> torch.Tensor:
    """One Jacobi sweep, as :func:`hs_sweep_plain`, written into ``out``
    (the shape of ``ut``) and returned. On the card every tensor is float32
    and contiguous, ``out`` does not overlap ``ut``, the flows are 8-byte
    aligned, H is at most ``MAX_ROWS`` and a row holds fewer than 2^31
    sites."""
    if (ut.dim() != it.dim() + 1 or it.dim() < 2 or ut.shape[-1] != 2 or tuple(ut.shape[:-1]) != tuple(it.shape)
            or out.shape != ut.shape):
        raise ValueError(f"expected flows (H, W, ..., 2) over maps (H, W, ...), got {tuple(ut.shape)} over "
                         f"{tuple(it.shape)}, out {tuple(out.shape)}")
    if not on_cuda(ut, u_w, it, ix, iy, denom, out):
        return out.copy_(hs_sweep_plain(ut, u_w, it, ix, iy, denom))
    h, w = it.shape[0], it.shape[1]
    b = it[0, 0].numel()
    if h > MAX_ROWS or w * b >= 2**31:
        raise ValueError(f"at most {MAX_ROWS} rows of fewer than 2^31 sites, got {h} rows of {w * b}")
    for name, t in (("ut", ut), ("u_w", u_w), ("out", out)):
        check_cuda_input(t, name, ut.shape)
    for name, t in (("it", it), ("ix", ix), ("iy", iy), ("denom", denom)):
        check_cuda_input(t, name, it.shape)
    if any(t.data_ptr() % 8 for t in (ut, u_w, out)):
        raise ValueError("the flows must be 8-byte aligned (a float2 a site)")
    if abs(out.data_ptr() - ut.data_ptr()) < ut.numel() * 4:
        raise ValueError("out overlaps ut")
    lib = build.load()
    with torch.cuda.device(ut.device):
        err = lib.vm_hs_sweep(ut.data_ptr(), u_w.data_ptr(), it.data_ptr(), ix.data_ptr(), iy.data_ptr(),
                              denom.data_ptr(), out.data_ptr(), h, w, b, stream_of(ut))
    build.check(err, "vm_hs_sweep")
    hs_sweep.launches += 1
    return out


hs_sweep.launches = 0
