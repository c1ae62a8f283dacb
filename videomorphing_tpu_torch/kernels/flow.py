"""The flows' kernels: kernel 5, one Horn-Schunck Jacobi sweep of a batch
of flows; kernels 6 and 7, one IRLS step of the robust flow.

Source: ``csrc/flow.cu`` (``vm_hs_sweep``, ``vm_irls_setup``,
``vm_irls_sweep``). They replace no TPU kernel: the reference's
``_hs_level`` and ``_robust_level`` (``videomorphing_tpu/video/flow.py``)
are plain ``jnp``. ``video.flow._hs_level`` runs ``flow_iters`` sweeps a
warp; in eager PyTorch each is about 19 launches and their temporaries,
here one launch that reads each input once and writes the new flow (bound
by bytes, 40 a site). ``video.flow._robust_level`` runs ``flow_irls`` IRLS
steps a warp, each about 100 eager launches for its weights and normal
matrix and about 45 a damped-Jacobi sweep; here one launch of kernel 6
(``irls_setup``: 88 bytes a site) and one of kernel 7 a sweep
(``irls_sweep``: 52 bytes a site).

Dispatch: a CPU tensor runs the plain PyTorch version; a CUDA tensor
launches the kernel or raises. Each wrapper's ``launches`` counts its
launches.
"""

from __future__ import annotations

import torch

from videomorphing_tpu_torch.kernels import build
from videomorphing_tpu_torch.kernels.warp import check_cuda_input, on_cuda, stream_of
from videomorphing_tpu_torch.ops.windows import edge_shifts

MAX_ROWS = 65535  # the launch grid's y extent: one grid row per image row
IRLS_MAPS = 9     # the channel maps a warp gives kernel 6, and the coefficients it writes


def _check_grid(h: int, row: int) -> None:
    if h > MAX_ROWS or row >= 2**31:
        raise ValueError(f"at most {MAX_ROWS} rows of fewer than 2^31 sites, got {h} rows of {row}")


def _check_aligned(*flows: torch.Tensor) -> None:
    if any(t.data_ptr() % 8 for t in flows):
        raise ValueError("the flows must be 8-byte aligned (a float2 a site)")


def _check_apart(out: torch.Tensor, *inputs: torch.Tensor) -> None:
    """Raise when ``out``'s memory overlaps an input's."""
    lo = out.data_ptr()
    hi = lo + out.numel() * out.element_size()
    for t in inputs:
        a = t.data_ptr()
        if a < hi and lo < a + t.numel() * t.element_size():
            raise ValueError("out overlaps an input")


def _check_irls_shapes(ut: torch.Tensor, stack: torch.Tensor, out: torch.Tensor, out_shape) -> None:
    """``ut`` (H, W, ..., 2) over a stack (9, H, W, ...), ``out`` of ``out_shape``."""
    if (ut.dim() < 3 or ut.shape[-1] != 2 or stack.dim() != ut.dim() or stack.shape[0] != IRLS_MAPS
            or tuple(stack.shape[1:]) != tuple(ut.shape[:-1]) or tuple(out.shape) != tuple(out_shape)):
        raise ValueError(f"expected flows (H, W, ..., 2) over a stack ({IRLS_MAPS}, H, W, ...), got "
                         f"{tuple(ut.shape)} over {tuple(stack.shape)}, out {tuple(out.shape)}")


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
    _check_grid(h, w * b)
    for name, t in (("ut", ut), ("u_w", u_w), ("out", out)):
        check_cuda_input(t, name, ut.shape)
    for name, t in (("it", it), ("ix", ix), ("iy", iy), ("denom", denom)):
        check_cuda_input(t, name, it.shape)
    _check_aligned(ut, u_w, out)
    _check_apart(out, ut)
    lib = build.load()
    with torch.cuda.device(ut.device):
        err = lib.vm_hs_sweep(ut.data_ptr(), u_w.data_ptr(), it.data_ptr(), ix.data_ptr(), iy.data_ptr(),
                              denom.data_ptr(), out.data_ptr(), h, w, b, stream_of(ut))
    build.check(err, "vm_hs_sweep")
    hs_sweep.launches += 1
    return out


hs_sweep.launches = 0


def irls_maps(intensity, grad_y, grad_x) -> torch.Tensor:
    """The stack (9, H, W, ...) of one warp's data channels that kernel 6
    reads: each channel's (residual at the warp's start, d/dy, d/dx), the
    intensity's (weight 1), then the y and x gradient constancy's (weight
    ``gamma``)."""
    return torch.stack([*intensity, *grad_y, *grad_x])


def irls_setup_plain(ut, u_w, maps, alpha2: float, eps2: float, eps2_s: float, gamma: float) -> torch.Tensor:
    """Plain version of kernel 6: one IRLS step's lagged weights and each
    site's normal matrix, for the flow ``ut`` (H, W, ..., 2) linearized at
    the warp's start ``u_w``. ``maps`` is the stack :func:`irls_maps`
    builds. Returns the
    stack (9, H, W, ...) of the four edge-replicated smoothness weights
    (up, down, left, right), then ``a11, a12, a22, b1, b2``; ``alpha2``,
    ``eps2`` and ``eps2_s`` are the squares of the smoothness weight, the
    data term's and the smoothness term's Charbonnier epsilon."""
    du = ut - u_w
    ws = []
    for n in edge_shifts(ut):
        d = n - ut
        ws.append(1.0 / torch.sqrt(torch.sum(d * d, -1) + eps2_s))
    wsum = ws[0] + ws[1] + ws[2] + ws[3]
    s = alpha2 * wsum * 0.25
    chans = [(maps[3 * c], maps[3 * c + 1], maps[3 * c + 2], cw) for c, cw in enumerate((1.0, gamma, gamma))]

    r2_sum = torch.zeros_like(s)
    for it_c, gy_c, gx_c, cw in chans:
        r = it_c + gy_c * du[..., 0] + gx_c * du[..., 1]
        r2_sum = r2_sum + cw * r * r
    w_pix = 1.0 / torch.sqrt(r2_sum + eps2)

    a11 = s
    a12 = torch.zeros_like(s)
    a22 = s
    b1 = torch.zeros_like(s)
    b2 = torch.zeros_like(s)
    for it_c, gy_c, gx_c, cw in chans:
        wc = cw * w_pix
        a11 = a11 + wc * gy_c * gy_c
        a12 = a12 + wc * gy_c * gx_c
        a22 = a22 + wc * gx_c * gx_c
        c = it_c - gy_c * u_w[..., 0] - gx_c * u_w[..., 1]
        b1 = b1 - wc * gy_c * c
        b2 = b2 - wc * gx_c * c
    return torch.stack(ws + [a11, a12, a22, b1, b2])


def irls_sweep_plain(ut, coef, alpha2: float) -> torch.Tensor:
    """Plain version of kernel 7: one damped-Jacobi sweep of ``ut`` (H, W,
    ..., 2) with the IRLS step's coefficients ``coef`` (9, H, W, ...), as
    :func:`irls_setup_plain` returns them: the weighted average of the
    edge-replicated neighbours, each site's 2x2 system solved in closed
    form, and half of the step taken. The sum of the weights, the diagonal
    term and the determinant are recomputed from ``coef``."""
    w0, w1, w2, w3, a11, a12, a22, b1, b2 = coef
    wsum = w0 + w1 + w2 + w3
    s = alpha2 * wsum * 0.25
    det = a11 * a22 - a12 * a12
    un_u, un_d, un_l, un_r = edge_shifts(ut)
    ua = (w0[..., None] * un_u + w1[..., None] * un_d + w2[..., None] * un_l + w3[..., None] * un_r) / wsum[..., None]
    r1 = s * ua[..., 0] + b1
    r2 = s * ua[..., 1] + b2
    uy = (a22 * r1 - a12 * r2) / det
    ux = (a11 * r2 - a12 * r1) / det
    return 0.5 * ut + 0.5 * torch.stack([uy, ux], -1)


def irls_setup(ut, u_w, maps, alpha2: float, eps2: float, eps2_s: float, gamma: float, out) -> torch.Tensor:
    """One IRLS step's weights and normal matrix, as
    :func:`irls_setup_plain`, written into ``out`` (the shape of ``maps``)
    and returned. On the card every tensor is float32 and contiguous,
    ``out`` overlaps no input, the flows are 8-byte aligned, H is at most
    ``MAX_ROWS`` and a row holds fewer than 2^31 sites."""
    _check_irls_shapes(ut, maps, out, maps.shape)
    if tuple(u_w.shape) != tuple(ut.shape):
        raise ValueError(f"u_w {tuple(u_w.shape)} is not the shape of ut {tuple(ut.shape)}")
    if not on_cuda(ut, u_w, maps, out):
        return out.copy_(irls_setup_plain(ut, u_w, maps, alpha2, eps2, eps2_s, gamma))
    h, w = ut.shape[0], ut.shape[1]
    b = ut[0, 0].numel() // 2
    _check_grid(h, w * b)
    for name, t in (("ut", ut), ("u_w", u_w)):
        check_cuda_input(t, name, ut.shape)
    for name, t in (("maps", maps), ("out", out)):
        check_cuda_input(t, name, maps.shape)
    _check_aligned(ut, u_w)
    _check_apart(out, ut, u_w, maps)
    lib = build.load()
    with torch.cuda.device(ut.device):
        err = lib.vm_irls_setup(ut.data_ptr(), u_w.data_ptr(), maps.data_ptr(), out.data_ptr(), h, w, b,
                                alpha2, eps2, eps2_s, gamma, stream_of(ut))
    build.check(err, "vm_irls_setup")
    irls_setup.launches += 1
    return out


def irls_sweep(ut, coef, alpha2: float, out) -> torch.Tensor:
    """One damped-Jacobi sweep, as :func:`irls_sweep_plain`, written into
    ``out`` (the shape of ``ut``) and returned; on the card as
    :func:`irls_setup` requires, ``out`` overlapping neither ``ut`` nor
    ``coef``."""
    _check_irls_shapes(ut, coef, out, ut.shape)
    if not on_cuda(ut, coef, out):
        return out.copy_(irls_sweep_plain(ut, coef, alpha2))
    h, w = ut.shape[0], ut.shape[1]
    b = ut[0, 0].numel() // 2
    _check_grid(h, w * b)
    for name, t in (("ut", ut), ("out", out)):
        check_cuda_input(t, name, ut.shape)
    check_cuda_input(coef, "coef", coef.shape)
    _check_aligned(ut, out)
    _check_apart(out, ut, coef)
    lib = build.load()
    with torch.cuda.device(ut.device):
        err = lib.vm_irls_sweep(ut.data_ptr(), coef.data_ptr(), out.data_ptr(), h, w, b, alpha2, stream_of(ut))
    build.check(err, "vm_irls_sweep")
    irls_sweep.launches += 1
    return out


irls_setup.launches = 0
irls_sweep.launches = 0
