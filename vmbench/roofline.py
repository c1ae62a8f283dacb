"""The chip's published peaks and the least time a kernel's work needs.

Frozen copies of the program's arithmetic, pinned by
``tests/test_vmbench_yardstick.py`` to fixed numbers: the bound of a pass
(each input read once and each output written once, against the H100
SXM's 3.35 TB/s; its operations against 67 TFLOP/s of float32 outside the
tensor cores; NVIDIA's data sheet, 700 W), the bytes and operations of the
sweep kernels per pixel, the pyramid's level sizes and the reference
bench's iterations per second per Mpx.
"""

from __future__ import annotations

from typing import List, Tuple

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least seconds the card could take for the bytes and operations."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS_PER_S)


def sweep_bytes(c: int, with_grad: bool, plane_bytes: int) -> int:
    """Bytes per pixel of the sweep gradient (``with_grad``) or energy: the
    6C warp planes and the 6 values of the UI/TC maps at ``plane_bytes``
    each, v and v_lin in float32, and the gradient's grad and precond."""
    return plane_bytes * (6 * c + 6) + 4 * 4 + (4 * 4 if with_grad else 0)


def sweep_ops_per_pixel(c: int, k: int, with_grad: bool) -> int:
    """Operations per pixel of the sweeps at an SSIM window of ``k`` taps:
    per channel the linearized warps (8), two passes of 5 window sums (20 k)
    and 3 products, the SSIM map (~20); with the gradient the coefficient
    maps (~20), 4 transposed sums in two passes (16 k), the chain through
    dw (10) and the curvature (8); then the curvature's window sum (4 k),
    the TPS maps and adjoint (~150) and the quadratic terms (~20)."""
    per_c = 8 + 20 * k + 3 + 20 + ((20 + 16 * k + 10 + 8) if with_grad else 0)
    rest = (4 * k + 150 + 20) if with_grad else (40 + 20)
    return c * per_c + rest


def sweep_grad_bound_s(h: int, w: int, c: int, k: int, plane_bytes: int = 4) -> float:
    """The least seconds of one sweep-gradient pass over an h x w level."""
    npx = h * w
    return bound_s(npx * sweep_bytes(c, True, plane_bytes), npx * sweep_ops_per_pixel(c, k, True))


def auto_n_levels(h: int, w: int, min_size: int = 32, max_levels: int = 16) -> int:
    """Pyramid levels such that the coarsest lands in [min_size, 2 min_size)."""
    n = 1
    while min(h, w) >= min_size * 2 and n < max_levels:
        h, w = -(-h // 2), -(-w // 2)
        n += 1
    return n


def pyramid_shapes(h: int, w: int, n_levels: int) -> List[Tuple[int, int]]:
    """(H, W) per level, finest first; each next level is ceil(prev / 2)."""
    shapes = [(h, w)]
    for _ in range(n_levels - 1):
        h, w = -(-h // 2), -(-w // 2)
        shapes.append((h, w))
    return shapes


def iters_per_s_per_mpix(iters: int, seconds: float, h: int, w: int) -> float:
    """Optimizer iterations over seconds over the finest level's Mpx."""
    return iters / seconds / (h * w / 1e6)
