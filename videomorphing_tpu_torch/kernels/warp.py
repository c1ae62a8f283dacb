"""Kernels 3 and 4: the halfway warp and the bilinear sampler.

Source: ``csrc/warp.cu`` (``vm_halfway_warp``, ``vm_bilinear_sample``).

- ``halfway_warp`` replaces ``videomorphing_tpu/pallas/warp.py:206``
  (``_build_warp_call``, driven by ``fused_warp_planes``);
  ``halfway_warp_rows``, its row-offset form, replaces the XLA gather of
  the row-sharded solve (``videomorphing_tpu/parallel/spatial.py:264-273``):
  a block of rows of the full frames, with zero planes outside the frame;
- ``bilinear_sample`` and ``bilinear_sample_batched`` replace
  ``videomorphing_tpu/pallas/warp.py:311`` (``_build_sample_call``, driven
  by ``fused_sample``); both launch one kernel, the first with n = 1.

Kernel 3 writes its plane stack in float32 or, with ``dtype=torch.bfloat16``,
in bfloat16 (each value rounded to nearest even as it is stored, the
reference's ``_build_warp_call(..., out_dtype=)``): the static pack of
``MorphParams.pack_dtype="bfloat16"``, which the sweep kernels read in that
dtype. Its plain version is the float32 plain version cast.

Both are bound by memory on the H100 (4 taps x C reads per image, one write
per output value). The TPU kernels enumerate per-tile residual offsets over
row-phase copies and fall back to an XLA gather when a tile's field is too
wild; on Hopper a gather is native, so each CUDA kernel gathers per output
pixel with no fit test and no fallback. Kernel 4 has one instantiation per
C in 1..4 with 8- and 16-byte loads and stores, chosen by
:func:`sample_vectorized` from C and the buffers' alignment, the scalar
instantiation of the same C otherwise, and a generic one for any other C.

Dispatch: a CPU tensor runs the plain PyTorch version; a CUDA tensor
launches the kernel or raises. Each wrapper counts its launches in a plain
integer attribute (``halfway_warp.launches``, ``bilinear_sample.launches``,
``bilinear_sample_batched.launches``); the row-offset form counts only
under ``halfway_warp_rows.launches``, and a bfloat16 output under
``launches_bf16`` of the same wrapper instead.
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


def check_cuda_input(t: torch.Tensor, name: str, shape=None, dtype=torch.float32) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {str(dtype).replace('torch.', '')}, got {t.dtype}")
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


PLANE_DTYPES = (torch.float32, torch.bfloat16)  # kernel 3's outputs; the sweep kernels' plane inputs


def _check_plane_dtype(dtype) -> None:
    if dtype not in PLANE_DTYPES:
        raise TypeError(f"the plane stack is float32 or bfloat16, not {dtype}")


def halfway_warp_plain(i0: torch.Tensor, i1: torch.Tensor, v: torch.Tensor,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of kernel 3: ``bilinear_sample_with_grad`` at g -/+ v,
    cast to ``dtype``."""
    g = resample.grid_coords(i0.shape[0], i0.shape[1], dtype=v.dtype, device=v.device)
    w0, dw0 = resample.bilinear_sample_with_grad(i0, g - v)
    w1, dw1 = resample.bilinear_sample_with_grad(i1, g + v)
    return planes_from_bundle(w0, dw0, w1, dw1).to(dtype)


def _launch_warp(i0: torch.Tensor, i1: torch.Tensor, v: torch.Tensor, row0: int, dtype) -> torch.Tensor:
    """Kernel 3 on the ``v.shape[0]`` rows from global row ``row0``, its
    planes stored in ``dtype``."""
    h, w, c = i0.shape
    ho = v.shape[0]
    check_cuda_input(i0, "i0")
    check_cuda_input(i1, "i1", (h, w, c))
    check_cuda_input(v, "v", (ho, w, 2))
    out = torch.empty((6 * c, ho, w), dtype=dtype, device=v.device)
    lib = build.load()
    with torch.cuda.device(v.device):
        err = lib.vm_halfway_warp(
            i0.data_ptr(), i1.data_ptr(), v.data_ptr(), out.data_ptr(), h, w, c, row0, ho,
            int(dtype == torch.bfloat16), stream_of(v)
        )
    build.check(err, "vm_halfway_warp")
    return out


def count_launch(wrapper, dtype, wide: bool = False) -> None:
    """One launch of ``wrapper``'s kernel in the form of ``dtype``: under
    ``launches_bf16`` for bfloat16, else under ``launches``; a launch of
    the sweeps' wide strip (``wide``) also under ``launches_wide_bf16`` or
    ``launches_wide``."""
    sfx = "_bf16" if dtype == torch.bfloat16 else ""
    setattr(wrapper, "launches" + sfx, getattr(wrapper, "launches" + sfx) + 1)
    if wide:
        setattr(wrapper, "launches_wide" + sfx, getattr(wrapper, "launches_wide" + sfx) + 1)


def halfway_warp(i0: torch.Tensor, i1: torch.Tensor, v: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Both halfway warps ``I0(p - v)``, ``I1(p + v)`` and their exact
    interpolant derivatives as one (6C, H, W) plane stack in ``dtype``
    (float32 or bfloat16), in the order of the reference's
    ``fused_warp_planes``; the sweep kernels read it as is."""
    _check_plane_dtype(dtype)
    if not on_cuda(i0, i1, v):
        return halfway_warp_plain(i0, i1, v, dtype)
    out = _launch_warp(i0, i1, v, 0, dtype)
    count_launch(halfway_warp, dtype)
    return out


halfway_warp.launches = 0
halfway_warp.launches_bf16 = 0


def halfway_warp_rows_plain(i0: torch.Tensor, i1: torch.Tensor, v: torch.Tensor, row0: int,
                            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of kernel 3's row-offset form: the sampler at the
    offset coordinates, times the row mask of the frame, cast to ``dtype``."""
    h, w = i0.shape[0], i0.shape[1]
    ys = torch.arange(row0, row0 + v.shape[0], dtype=v.dtype, device=v.device)
    xs = torch.arange(w, dtype=v.dtype, device=v.device)
    g = torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1)
    w0, dw0 = resample.bilinear_sample_with_grad(i0, g - v)
    w1, dw1 = resample.bilinear_sample_with_grad(i1, g + v)
    inside = ((ys >= 0) & (ys < h)).to(v.dtype)[None, :, None]
    return (planes_from_bundle(w0, dw0, w1, dw1) * inside).to(dtype)


def halfway_warp_rows(i0: torch.Tensor, i1: torch.Tensor, v: torch.Tensor, row0: int,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Kernel 3 on a block of rows: the (6C, Ho, W) planes, in ``dtype``, of
    the global rows ``[row0, row0 + Ho)`` of the full frames ``i0``/``i1``
    (H, W, C) at the block's field ``v`` (Ho, W, 2); rows outside ``[0, H)``
    are zero planes. ``row0 = 0`` with ``Ho = H`` is :func:`halfway_warp`."""
    _check_plane_dtype(dtype)
    if not on_cuda(i0, i1, v):
        return halfway_warp_rows_plain(i0, i1, v, row0, dtype)
    out = _launch_warp(i0, i1, v, int(row0), dtype)
    count_launch(halfway_warp_rows, dtype)
    return out


halfway_warp_rows.launches = 0
halfway_warp_rows.launches_bf16 = 0


MAX_BATCH = 65535  # the launch grid's y extent: one grid row per image

# The vector instantiations of kernel 4 per channel count C (csrc/warp.cu
# VectorForm<C>): outputs per thread, then the byte alignment that the
# image, the coordinates and the output need for their wide accesses.
VECTOR_FORMS = {1: (4, 4, 16, 16), 2: (2, 8, 16, 16), 3: (4, 4, 16, 16), 4: (1, 16, 8, 16)}


def sample_vectorized(c: int, n: int, m: int, img_ptr: int, coords_ptr: int, out_ptr: int) -> bool:
    """Whether kernel 4 runs its vector instantiation for C = ``c`` on n
    images of ``m`` coordinate pairs each at these addresses, rather than the
    scalar instantiation of the same C: only C in 1..4 has one, every
    pointer must be aligned for its wide accesses, and with n > 1 each
    image's coordinates and outputs must start aligned too (m a multiple of
    the outputs per thread)."""
    if c not in VECTOR_FORMS:
        return False
    vec, img_align, coords_align, out_align = VECTOR_FORMS[c]
    return (img_ptr % img_align == 0 and coords_ptr % coords_align == 0
            and out_ptr % out_align == 0 and (n == 1 or m % vec == 0))


def _launch_sample(imgs: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Kernel 4 on ``imgs`` (n, H, W, C) and ``coords`` (n, M, 2), M >= 1."""
    n, h, w, c = imgs.shape
    m = coords.shape[1]
    if n > MAX_BATCH:
        raise ValueError(f"at most {MAX_BATCH} images per launch, got {n}")
    check_cuda_input(imgs, "img")
    check_cuda_input(coords, "coords")
    out = torch.empty((n, m, c), dtype=torch.float32, device=imgs.device)
    vector = sample_vectorized(c, n, m, imgs.data_ptr(), coords.data_ptr(), out.data_ptr())
    lib = build.load()
    with torch.cuda.device(imgs.device):
        err = lib.vm_bilinear_sample(
            imgs.data_ptr(), coords.data_ptr(), out.data_ptr(), n, h, w, c, m, int(vector),
            stream_of(imgs),
        )
    build.check(err, "vm_bilinear_sample")
    return out


def bilinear_sample_plain(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 4."""
    return resample.bilinear_sample(img, coords)


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear edge-clamp values of ``img`` (H, W, C) or (H, W) at
    ``coords`` (..., 2) in (y, x) -> (..., C) or (...), as
    ``ops.resample.bilinear_sample``.

    The shapes are brought to the kernel's (H, W, C) x (1, M, 2) contract
    before the device dispatch, so the CPU path runs the same reshaping; an
    empty coordinate set returns an empty result without a launch.
    """
    if img.dim() not in (2, 3) or coords.dim() < 1 or coords.shape[-1] != 2:
        raise ValueError(
            f"expected (H, W[, C]) and (..., 2), got {tuple(img.shape)}, {tuple(coords.shape)}"
        )
    squeeze = img.dim() == 2
    img3 = img[..., None] if squeeze else img
    lead = tuple(coords.shape[:-1])
    flat = coords.reshape(1, -1, 2)
    if not on_cuda(img3, flat):
        out = bilinear_sample_plain(img3, flat)
    elif flat.shape[1] == 0:
        out = flat.new_empty((1, 0, img3.shape[-1]))
    else:
        out = _launch_sample(img3.contiguous()[None], flat.contiguous())
        bilinear_sample.launches += 1
    out = out.reshape(lead + (img3.shape[-1],))
    return out[..., 0] if squeeze else out


bilinear_sample.launches = 0


def bilinear_sample_batched_plain(imgs: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 4's batched form."""
    return resample.bilinear_sample_batched(imgs, coords)


def bilinear_sample_batched(imgs: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Kernel 4 on n images of one shape in one launch, each at its own
    coordinate map: ``imgs`` (n, H, W, C), ``coords`` (n, Ho, Wo, 2) ->
    (n, Ho, Wo, C), equal to ``[bilinear_sample(imgs[k], coords[k])]``.

    The contract of the reference's ``fused_sample(srcs, coords)``, whose
    C <= 4 limit comes from the TPU's channel blocking; this kernel takes
    any C. It serves the flow warps batched over frame pairs, the
    occlusion confidences batched over frames and the render's two colour
    samples.
    """
    if (imgs.dim() != 4 or coords.dim() != 4 or coords.shape[0] != imgs.shape[0]
            or coords.shape[-1] != 2 or imgs.shape[-1] < 1):
        raise ValueError(
            f"expected (n, H, W, C) and (n, Ho, Wo, 2), got "
            f"{tuple(imgs.shape)}, {tuple(coords.shape)}"
        )
    if not on_cuda(imgs, coords):
        return bilinear_sample_batched_plain(imgs, coords)
    n, ho, wo = coords.shape[0], coords.shape[1], coords.shape[2]
    if n * ho * wo == 0:
        return coords.new_empty((n, ho, wo, imgs.shape[-1]))
    out = _launch_sample(imgs.contiguous(), coords.contiguous().reshape(n, ho * wo, 2))
    bilinear_sample_batched.launches += 1
    return out.reshape(n, ho, wo, imgs.shape[-1])


bilinear_sample_batched.launches = 0
