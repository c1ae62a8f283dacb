"""Kernels 1 and 2: the solver's sweep gradient and sweep energy.

Source: ``csrc/sweep.cu`` (``vm_sweep_grad`` launches
``sweep_grad_kernel<R>`` or ``sweep_grad_strip_kernel<R>``,
``vm_sweep_energy`` ``sweep_energy_kernel<R>``; they share their
per-pixel arithmetic as ``__device__`` functions).

Every odd ``ssim_window`` = 2R + 1 runs on the card, chosen by R in
``csrc/sweep.cu``'s ``dispatch`` (:func:`kernel_name`): the gradient
kernel's tile for R = 1, 2 (windows 3, 5), its strip for R =
``STRIP_MIN_RADIUS`` .. ``STRIP_MAX_RADIUS`` (3 .. 7, windows 7-15), the
energy kernel for R = 1 .. ``TILED_MAX_RADIUS`` (6, window 13); any other R
(window 1, and past those) takes the wide path, per-pixel kernels that
read R at run time and keep their intermediates in a scratch buffer this
wrapper allocates. The taps
sit in a small device buffer per window (:func:`window_taps`). An even
window's taps are not centred on the pixel, so no kernel computes it: on
the card it raises ``ValueError`` (the reference and the plain version
fail on it too).

- ``sweep_grad`` replaces ``videomorphing_tpu/pallas/sweep.py:293``
  (``_build_grad_call``, driven by ``fused_value_grad_precond_pack``);
- ``sweep_energy`` replaces ``videomorphing_tpu/pallas/sweep.py:502``
  (``_build_energy_call``, driven by ``fused_total_energy_pack``);
- ``sweep_grad_shard`` and ``sweep_energy_shard``, the row-shard forms of
  the same kernels, replace ``fused_grad_parts_shard`` (``sweep.py:936``)
  and ``fused_energy_parts_shard`` (``:959``), which drive the same two
  builders with a global pixel count and an ownership plane.

Both evaluate the halfway-domain energy on the warps linearized around
``v_lin``: ``a0 = w0 - dw0.(v - v_lin)``, ``a1 = w1 + dw1.(v - v_lin)``.
On paper they are bound by bytes on the H100; in practice by instructions
and their latency (~29 window sums and ~60 maps per pixel and channel,
over a halo). The gradient kernel's tile (R = 1, 2) stages a tile of
owned pixels (:func:`sweep_tile`) and its halo of twice the window radius
in shared memory, channel by channel through ``cp.async`` with the next
channel's planes in flight, so every window sum, the dw chain and the TPS
stencils read shared memory; its strip (wider windows) walks down a
column strip a few rows a step, with the linearized warps and the SSIM
coefficient maps in rings of rows, so the vertical halo is staged once
per strip and channel. The energy kernel needs no gradient halo: each warp
walks a column strip with the window's rows in registers and the
neighbouring columns from its lanes. The inputs are the warp kernel's
plane stack as it comes, with no pack.

Two forms, chosen by the tensors (``MorphParams.pack_dtype``): float32,
and bfloat16, where the plane stack and the four UI/TC maps are bfloat16
(``halfway_warp(..., dtype=torch.bfloat16)``) and ``v_lin``, ``v`` stay
float32. The bfloat16 form is the reference's bf16 pack: every value read
in bf16 is upcast and all arithmetic is float32, but 1/n, which the
reference stores in its pack too, is rounded to bf16 before use. Its
plain version is the float32 one on the upcast inputs with 1/n so
rounded (``inv_n_dtype``); :func:`quantize_v_lin` rounds the
linearization point as the reference does before each re-warp. Other
dtypes, or planes and maps of different dtypes, raise.
Energy partials reduce in a fixed order (no float atomics), so reruns are
bitwise identical.

A row shard is a block of a frame's rows extended by ``halo`` real
neighbour rows above and below (zero rows beyond the frame, as
``parallel.halo.halo_exchange_rows`` gives them): the kernel tests rows
against the global frame, normalizes by the global pixel count and returns
the block's RAW partials (sim, tps, ui, tc) of its owned rows; the caller
sums them over the blocks in block order and combines them with
:func:`combine_parts`.

Dispatch: a CPU tensor runs the plain PyTorch version (``linearized_warps``
+ ``value_grad_precond_planes`` / ``total_energy_planes``; for a shard the
port of the reference's jnp shard branch, ``parallel/spatial.py:44-61,
172-224``); a CUDA tensor launches the kernel or raises. Launch counts:
``sweep_grad.launches``, ``sweep_energy.launches``,
``sweep_grad_shard.launches`` and ``sweep_energy_shard.launches``; the
bfloat16 form counts under ``launches_bf16`` of the same wrapper instead.
"""

from __future__ import annotations

import ctypes
import functools
import re

import numpy as np
import torch

from videomorphing_tpu_torch.config import MorphParams
from videomorphing_tpu_torch.kernels import build
from videomorphing_tpu_torch.kernels.warp import PLANE_DTYPES, check_cuda_input, count_launch, on_cuda, stream_of
from videomorphing_tpu_torch.ops.windows import gaussian_taps, separable_filter

_GEOMETRY = ("TILE_ROWS", "TILE_COLS", "ENERGY_TILE_ROWS", "ENERGY_TILE_COLS", "TILED_MAX_RADIUS",
             "WIDE_TILE_ROWS", "WIDE_TILE_COLS", "STRIP_ROWS", "STRIP_COLS", "STRIP_MIN_RADIUS",
             "STRIP_MAX_RADIUS")


@functools.lru_cache(maxsize=None)
def _geometry() -> dict:
    """The tiles and the tiled kernels' largest radius, read from
    ``csrc/sweep.cu``, the one place they are set."""
    text = (build.CSRC_DIR / "sweep.cu").read_text()
    found = {name: re.search(rf"^constexpr int {name} = (\d+);", text, re.M) for name in _GEOMETRY}
    missing = [name for name, m in found.items() if not m]
    if missing:
        raise RuntimeError(f"csrc/sweep.cu does not set {' and '.join(missing)}")
    return {name: int(m.group(1)) for name, m in found.items()}


def tiled(with_grad: bool, radius: int) -> bool:
    """Whether window radius R runs a kernel instantiated for it rather
    than the wide path: the gradient kernel (``with_grad``) for R = 1 ..
    ``STRIP_MAX_RADIUS``, the energy kernel for R = 1 ..
    ``TILED_MAX_RADIUS``."""
    g = _geometry()
    return 1 <= radius <= g["STRIP_MAX_RADIUS" if with_grad else "TILED_MAX_RADIUS"]


def kernel_name(with_grad: bool, radius: int) -> str:
    """The kernel of ``csrc/sweep.cu`` that runs at window radius
    ``radius``: ``sweep_grad_kernel<R>`` (the gradient's tile),
    ``sweep_grad_strip_kernel<R>`` (its strip), ``sweep_energy_kernel<R>``
    or the wide path."""
    if not tiled(with_grad, radius):
        return f"wide path ({'gradient' if with_grad else 'energy'})"
    if not with_grad:
        return f"sweep_energy_kernel<{radius}>"
    strip = radius >= _geometry()["STRIP_MIN_RADIUS"]
    return f"sweep_grad{'_strip' if strip else ''}_kernel<{radius}>"


def sweep_tile(with_grad: bool, radius: int = 1) -> tuple[int, int]:
    """(rows, columns) of owned pixels per block, one partials set each,
    at window radius ``radius``: the gradient kernel's ``TILE_ROWS`` x
    ``TILE_COLS`` below ``STRIP_MIN_RADIUS`` and its strip of
    ``STRIP_ROWS`` x ``STRIP_COLS`` from there (``with_grad``); the energy
    kernel's ``ENERGY_TILE_ROWS`` x ``ENERGY_TILE_COLS`` up to R = 3, whose
    lanes give a wider window's halo max(3, R) columns each side of 32
    (``energy_tile_cols``); the wide path's ``WIDE_TILE_ROWS`` x
    ``WIDE_TILE_COLS`` for both."""
    g = _geometry()
    if not tiled(with_grad, radius):
        return g["WIDE_TILE_ROWS"], g["WIDE_TILE_COLS"]
    if with_grad and radius >= g["STRIP_MIN_RADIUS"]:
        return g["STRIP_ROWS"], g["STRIP_COLS"]
    if with_grad:
        return g["TILE_ROWS"], g["TILE_COLS"]
    halo = max((32 - g["ENERGY_TILE_COLS"]) // 2, radius)
    return g["ENERGY_TILE_ROWS"], 32 - 2 * halo


def n_partials(w: int, nown: int, with_grad: bool, radius: int = 1) -> int:
    """Blocks of a launch of the gradient (``with_grad``) or the energy
    kernel over ``nown`` owned rows of width ``w`` at window radius
    ``radius``, each writing one set of (sim, tps, ui, tc) partials;
    ``vm_sweep_n_partials`` computes the same count on the card, and the
    kernel refuses a buffer that holds fewer."""
    rows, cols = sweep_tile(with_grad, radius)
    return -(-nown // rows) * -(-w // cols)


class _Scalars(ctypes.Structure):
    """Mirror of ``VmSweepScalars`` in ``csrc/sweep.cu``."""

    _fields_ = [
        ("taps", ctypes.c_void_p),
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
        ("row0", ctypes.c_int),
        ("gh", ctypes.c_int),
        ("own0", ctypes.c_int),
        ("nown", ctypes.c_int),
    ]


def kernel_radius(p: MorphParams) -> int:
    """The radius R of the kernels' window, ``ssim_window`` = 2R + 1;
    raises ``ValueError`` for an even window, whose taps are not centred
    on the pixel (the kernels would read 2R + 1 of its taps and compute
    another function than the plain version)."""
    k = int(p.ssim_window)
    if k < 1 or k % 2 == 0:
        raise ValueError(
            f"the sweep kernels take an odd ssim_window (2R + 1 taps centred on the pixel), got {k}"
        )
    return (k - 1) // 2


_TAPS: dict = {}


def window_taps(p: MorphParams, device) -> torch.Tensor:
    """The window's 2R + 1 Gaussian taps (float32) on ``device``: the
    buffer ``VmSweepScalars.taps`` points at, made once per window, sigma
    and device and kept (on a card, its copy is synchronized before use,
    so no stream reads it early)."""
    dev = torch.device(device)
    key = (int(p.ssim_window), float(p.ssim_sigma), dev)
    taps = _TAPS.get(key)
    if taps is None:
        taps = torch.tensor(gaussian_taps(key[0], key[1]), dtype=torch.float32).to(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        _TAPS[key] = taps
    return taps


def _scalars(p: MorphParams, h: int, w: int, c: int, row0: int = 0, gh: int = 0, own0: int = 0,
             nown: int = 0, taps: torch.Tensor | None = None) -> _Scalars:
    """Kernel constants, each computed in double and rounded once to
    float32, as the reference's weakly typed Python constants are. The
    defaults describe a whole frame; a row shard passes its block geometry
    and every ``/npix`` uses the global ``gh * w``. ``taps`` is the
    window's buffer (:func:`window_taps`) on the launch's device."""
    r = kernel_radius(p)
    gh = gh or h
    nown = nown or h
    npix = gh * w
    s = _Scalars()
    if taps is not None:
        if taps.numel() != 2 * r + 1:
            raise ValueError(f"{taps.numel()} taps for a window of radius {r}")
        s.taps = taps.data_ptr()
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
    s.row0, s.gh, s.own0, s.nown = row0, gh, own0, nown
    return s


_PACK_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def pack_dtype(p: MorphParams) -> torch.dtype:
    """The dtype of ``p.pack_dtype`` (the reference's ``_pack_dtype``);
    raises ``ValueError`` for any other value."""
    if p.pack_dtype not in _PACK_DTYPES:
        raise ValueError(f"unknown pack_dtype {p.pack_dtype!r}")
    return _PACK_DTYPES[p.pack_dtype]


def quantize_v_lin(v: torch.Tensor, p: MorphParams) -> torch.Tensor:
    """The linearization point rounded to the pack's dtype (nearest even)
    and back, so that the warp planes and ``v_lin`` describe one point and
    ``v - v_lin`` absorbs the rounding; a no-op at float32 (the reference's
    ``quantize_v_lin``, ``pallas/sweep.py:95``)."""
    dt = pack_dtype(p)
    return v if dt == torch.float32 else v.to(dt).to(v.dtype)


_MAP_NAMES = ("ui_w", "ui_v", "tc_w", "tc_v")


def _maps(data) -> tuple:
    return tuple(getattr(data, k) for k in _MAP_NAMES)


def pack_maps(data, dtype: torch.dtype):
    """``data`` (a ``LevelData``) with its four UI/TC maps in ``dtype``, the
    images as they are: the bf16 pack stores the maps in bfloat16, the
    plain versions read them in float32."""
    if all(m.dtype == dtype for m in _maps(data)):
        return data
    return data._replace(**{k: m.to(dtype) for k, m in zip(_MAP_NAMES, _maps(data))})


def plane_dtype(planes, data) -> torch.dtype:
    """The form of a call: the dtype of ``planes`` (6C, H, W) and of the
    four UI/TC maps, float32 or bfloat16; raises if they differ."""
    dtypes = {planes.dtype} | {m.dtype for m in _maps(data)}
    if len(dtypes) != 1 or planes.dtype not in PLANE_DTYPES:
        raise TypeError(
            "the planes and the UI/TC maps are all float32 or all bfloat16, got "
            + ", ".join(str(t.dtype) for t in (planes,) + _maps(data))
        )
    return planes.dtype


def _upcast(planes, data):
    """The plain versions' inputs: the planes and the UI/TC maps in
    float32 (exact from bfloat16), and the dtype 1/n is rounded to."""
    dt = plane_dtype(planes, data)
    return planes.float(), pack_maps(data, torch.float32), dt


def _check(planes, v_lin, v, data, halo: int = 0):
    """Shapes of a (whole or shard) call: ``planes`` (6C, H, W), ``v_lin``
    and ``v`` (H, W, 2), the data maps on the H - 2 halo owned rows; the
    planes and maps in one of ``PLANE_DTYPES``, ``v_lin`` and ``v``
    float32. Returns (H, W, C, the planes' dtype)."""
    c6, h, w = planes.shape
    if c6 % 6:
        raise ValueError(f"planes: expected (6C, H, W), got {tuple(planes.shape)}")
    bh = h - 2 * halo
    dt = plane_dtype(planes, data)
    check_cuda_input(planes, "planes", dtype=dt)
    check_cuda_input(v_lin, "v_lin", (h, w, 2))
    check_cuda_input(v, "v", (h, w, 2))
    for name, m, k in zip(_MAP_NAMES, _maps(data), (1, 2, 1, 2)):
        check_cuda_input(m, name, (bh, w, k), dt)
    return h, w, c6 // 6, dt


def sweep_grad_plain(planes, v_lin, v, data, p: MorphParams):
    """Plain version of kernel 1."""
    from videomorphing_tpu_torch.kernels.warp import bundle_from_planes
    from videomorphing_tpu_torch.solver.descent import (
        WarpBundle,
        linearized_warps,
        value_grad_precond_planes,
    )

    planes, data, dt = _upcast(planes, data)
    w0, dw0, w1, dw1 = bundle_from_planes(planes)
    w0e, w1e = linearized_warps(WarpBundle(v_lin, w0, dw0, w1, dw1), v)
    return value_grad_precond_planes(w0e, dw0, w1e, dw1, v, data, p, inv_n_dtype=dt)


def sweep_energy_plain(planes, v_lin, v, data, p: MorphParams):
    """Plain version of kernel 2."""
    from videomorphing_tpu_torch.kernels.warp import bundle_from_planes
    from videomorphing_tpu_torch.solver.descent import (
        WarpBundle,
        linearized_warps,
        total_energy_planes,
    )

    planes, data, dt = _upcast(planes, data)
    w0, dw0, w1, dw1 = bundle_from_planes(planes)
    w0e, w1e = linearized_warps(WarpBundle(v_lin, w0, dw0, w1, dw1), v)
    return total_energy_planes(w0e, w1e, v, data, p, inv_n_dtype=dt)


def _launch(with_grad: bool, planes, v_lin, v, data, p: MorphParams, row0: int = 0, gh: int = 0,
            halo: int = 0):
    """One launch of a sweep kernel (and its reduce) on a whole frame or,
    with ``halo`` > 0, on a row shard; returns (out (5,), grad, precond)."""
    h, w, c, dt = _check(planes, v_lin, v, data, halo)
    bf16 = dt == torch.bfloat16
    r = kernel_radius(p)
    bh = h - 2 * halo
    dev = v.device
    s = _scalars(p, h, w, c, row0, gh or h, halo, bh, window_taps(p, dev))
    n_parts = n_partials(w, bh, with_grad, r)
    partials = torch.empty((n_parts, 4), dtype=torch.float32, device=dev)
    out = torch.empty((5,), dtype=torch.float32, device=dev)
    lib = build.load()
    # the wide path's intermediates (none for the tiled kernels)
    n_scratch = 0 if tiled(with_grad, r) else lib.vm_sweep_scratch_floats(w, bh, int(with_grad), r)
    scratch = torch.empty((n_scratch,), dtype=torch.float32, device=dev) if n_scratch else None
    scratch_ptr = scratch.data_ptr() if scratch is not None else None
    grad = precond = None
    with torch.cuda.device(dev):
        if with_grad:
            grad = torch.empty((bh, w, 2), dtype=torch.float32, device=dev)
            precond = torch.empty((bh, w, 2), dtype=torch.float32, device=dev)
            err = (lib.vm_sweep_grad_bf16 if bf16 else lib.vm_sweep_grad)(
                planes.data_ptr(), v_lin.data_ptr(), v.data_ptr(),
                data.ui_w.data_ptr(), data.ui_v.data_ptr(),
                data.tc_w.data_ptr(), data.tc_v.data_ptr(),
                grad.data_ptr(), precond.data_ptr(), partials.data_ptr(), n_parts,
                scratch_ptr, n_scratch, out.data_ptr(), ctypes.addressof(s), stream_of(v),
            )
        else:
            err = (lib.vm_sweep_energy_bf16 if bf16 else lib.vm_sweep_energy)(
                planes.data_ptr(), v_lin.data_ptr(), v.data_ptr(),
                data.ui_w.data_ptr(), data.ui_v.data_ptr(),
                data.tc_w.data_ptr(), data.tc_v.data_ptr(),
                partials.data_ptr(), n_parts, scratch_ptr, n_scratch, out.data_ptr(),
                ctypes.addressof(s), stream_of(v),
            )
    build.check(err, ("vm_sweep_grad" if with_grad else "vm_sweep_energy") + ("_bf16" if bf16 else ""))
    return out, grad, precond


def sweep_grad(planes, v_lin, v, data, p: MorphParams):
    """``(energy, grad, precond)`` at ``v`` on the warps linearized around
    ``v_lin``; ``planes`` is the (6C, H, W) stack of ``halfway_warp``.
    ``energy`` is a 0-d tensor on the input's device."""
    if not on_cuda(planes, v_lin, v, data.ui_w, data.ui_v, data.tc_w, data.tc_v):
        return sweep_grad_plain(planes, v_lin, v, data, p)
    out, grad, precond = _launch(True, planes, v_lin, v, data, p)
    count_launch(sweep_grad, planes.dtype)
    return out[4], grad, precond


sweep_grad.launches = 0
sweep_grad.launches_bf16 = 0


def sweep_energy(planes, v_lin, v, data, p: MorphParams):
    """Total energy (0-d tensor) at ``v`` on the linearized warps."""
    if not on_cuda(planes, v_lin, v, data.ui_w, data.ui_v, data.tc_w, data.tc_v):
        return sweep_energy_plain(planes, v_lin, v, data, p)
    out, _, _ = _launch(False, planes, v_lin, v, data, p)
    count_launch(sweep_energy, planes.dtype)
    return out[4]


sweep_energy.launches = 0
sweep_energy.launches_bf16 = 0


# ---------------------------------------------------------------------------
# row-shard forms (the row-sharded level solve, parallel/spatial.py)
# ---------------------------------------------------------------------------


def shard_reach(p: MorphParams) -> int:
    """Neighbour rows a shard needs above and below its owned rows: the
    linearized warps' 2R (statistics R plus the transposed sums R) and the
    TPS adjoint's 2, at any window."""
    return max(2 * (int(p.ssim_window) // 2), 2)


def combine_parts(parts, p: MorphParams, npix: int, c: int) -> np.float32:
    """The total energy from raw partials (sim, tps, ui, tc) summed over all
    shards, in float32 as the reference's ``combine_energy_parts``."""
    ps = np.asarray(parts, dtype=np.float32).reshape(4)
    f = np.float32
    return (ps[0] / f(npix * c) + f(p.lambda_tps) * ps[1] / f(npix)
            + f(p.gamma_ui) * ps[2] / f(npix) + f(p.beta_tc) * ps[3] / f(npix))


def _masked_tps_maps(v_ext: torch.Tensor, vld_rows: torch.Tensor):
    """Second-difference maps of an extended block, zero where the stencil
    crosses the frame's top or bottom (``vld_rows`` (He, 1, 1) is the
    in-frame row indicator); port of ``spatial._masked_tps_maps``."""
    from videomorphing_tpu_torch.solver.energy import tps_maps

    vxx, vxy, vyy = tps_maps(v_ext)
    ok_y = torch.zeros_like(vld_rows)
    ok_y[1:-1] = vld_rows[:-2] * vld_rows[1:-1] * vld_rows[2:]
    return vxx * vld_rows, vxy * ok_y, vyy * ok_y


def _shard_plain(with_grad: bool, planes, v_lin, v, data, p: MorphParams, row0: int, gh: int, halo: int):
    """Plain version of the shard forms: the reference's jnp shard branch
    (``masked_energy``, ``value_grad_precond``) on the extended block,
    returning raw partials like the kernel."""
    from videomorphing_tpu_torch.kernels.warp import bundle_from_planes
    from videomorphing_tpu_torch.ops.ssim import dssim_grad_bundle
    from videomorphing_tpu_torch.solver.descent import (
        WarpBundle,
        linearized_warps,
        tps_adj_xx,
        tps_adj_xy,
        tps_adj_yy,
    )

    planes, data, dt = _upcast(planes, data)
    he, w = v.shape[0], v.shape[1]
    c = planes.shape[0] // 6
    npix = gh * w
    crop = lambda a: a[halo:he - halo]
    w0, dw0, w1, dw1 = bundle_from_planes(planes)
    w0e, w1e = linearized_warps(WarpBundle(v_lin, w0, dw0, w1, dw1), v)
    ys = torch.arange(row0, row0 + he, device=v.device)
    vld_rows = ((ys >= 0) & (ys < gh)).to(v.dtype)[:, None, None]
    vld = vld_rows.expand(he, w, 1)
    bundle = dssim_grad_bundle(
        w0e, w1e, window=p.ssim_window, sigma=p.ssim_sigma,
        c1=p.ssim_c1, c2=p.ssim_c2, use_luminance=p.ssim_use_luminance, valid=vld, inv_n_dtype=dt,
    )
    vxx, vxy, vyy = _masked_tps_maps(v, vld_rows)
    tmap = torch.sum(vxx * vxx + 2.0 * vxy * vxy + vyy * vyy, dim=-1)
    v_in = crop(v)
    d_ui = v_in - data.ui_v
    d_tc = v_in - data.tc_v
    parts = torch.stack([
        torch.sum(crop(bundle.dmap)) * c,
        torch.sum(crop(tmap)),
        torch.sum(data.ui_w * torch.sum(d_ui * d_ui, -1, keepdim=True)),
        torch.sum(data.tc_w * torch.sum(d_tc * d_tc, -1, keepdim=True)),
    ])
    if not with_grad:
        return parts
    # the bundle normalizes by the extended block's size; rescale to global
    rescale = (he * w * c) / (npix * c)
    g0 = bundle.g0 * rescale
    g1 = bundle.g1 * rescale
    g_sim = -(g0[..., None] * dw0).sum(2) + (g1[..., None] * dw1).sum(2)
    lam_n = p.lambda_tps / npix
    g_tps = lam_n * (2.0 * tps_adj_xx(vxx) + 4.0 * tps_adj_xy(vxy) + 2.0 * tps_adj_yy(vyy))
    grad = crop(g_sim + g_tps)
    grad = grad + (2.0 * p.gamma_ui / npix) * data.ui_w * d_ui
    grad = grad + (2.0 * p.beta_tc / npix) * data.tc_w * d_tc

    k = gaussian_taps(int(p.ssim_window), float(p.ssim_sigma))
    inv_b2 = vld / bundle.b2
    curv_y = torch.sum((dw0[..., 0] ** 2 + dw1[..., 0] ** 2) * inv_b2, dim=-1)
    curv_x = torch.sum((dw0[..., 1] ** 2 + dw1[..., 1] ** 2) * inv_b2, dim=-1)
    curv = crop(separable_filter(torch.stack([curv_y, curv_x], dim=-1), k, k, mode="same_zero"))
    p_sim = (2.0 / (npix * c)) * curv
    p_quad = (2.0 / npix) * (p.gamma_ui * data.ui_w + p.beta_tc * data.tc_w)
    precond = p_sim + lam_n * 25.0 + p_quad + p.precond_eps / npix
    return parts, grad, precond


def sweep_grad_shard_plain(planes, v_lin, v, data, p: MorphParams, row0: int, gh: int, halo: int):
    """Plain version of kernel 1's shard form."""
    return _shard_plain(True, planes, v_lin, v, data, p, row0, gh, halo)


def sweep_energy_shard_plain(planes, v_lin, v, data, p: MorphParams, row0: int, gh: int, halo: int):
    """Plain version of kernel 2's shard form."""
    return _shard_plain(False, planes, v_lin, v, data, p, row0, gh, halo)


def _check_shard(p: MorphParams, v, row0: int, gh: int, halo: int) -> None:
    if halo < shard_reach(p) or v.shape[0] <= 2 * halo:
        raise ValueError(
            f"row shard of {v.shape[0]} rows with halo {halo}: need halo >= {shard_reach(p)} "
            "and at least one owned row"
        )
    if not (row0 + halo >= 0 and row0 + v.shape[0] - halo <= gh):
        raise ValueError(f"owned rows from {row0 + halo} leave the frame of {gh} rows")


def sweep_grad_shard(planes, v_lin, v, data, p: MorphParams, row0: int, gh: int, halo: int):
    """Kernel 1 on one row shard: ``(parts (4,), grad, precond)``.

    ``planes`` (6C, He, W), ``v_lin`` and ``v`` (He, W, 2) cover the block
    extended by ``halo`` rows above and below (``halfway_warp_rows`` at
    ``row0``, the global row of the extended block's first row); ``data``
    holds the owned rows' (He - 2 halo, W, .) constraint maps; ``gh`` is the
    frame's height. ``grad``/``precond`` cover the owned rows, normalized by
    the global pixel count; ``parts`` are the owned rows' raw partials."""
    _check_shard(p, v, row0, gh, halo)
    if not on_cuda(planes, v_lin, v, data.ui_w, data.ui_v, data.tc_w, data.tc_v):
        return sweep_grad_shard_plain(planes, v_lin, v, data, p, row0, gh, halo)
    out, grad, precond = _launch(True, planes, v_lin, v, data, p, row0, gh, halo)
    count_launch(sweep_grad_shard, planes.dtype)
    return out[:4], grad, precond


sweep_grad_shard.launches = 0
sweep_grad_shard.launches_bf16 = 0


def sweep_energy_shard(planes, v_lin, v, data, p: MorphParams, row0: int, gh: int, halo: int):
    """Kernel 2 on one row shard: the owned rows' raw partials (4,)."""
    _check_shard(p, v, row0, gh, halo)
    if not on_cuda(planes, v_lin, v, data.ui_w, data.ui_v, data.tc_w, data.tc_v):
        return sweep_energy_shard_plain(planes, v_lin, v, data, p, row0, gh, halo)
    out, _, _ = _launch(False, planes, v_lin, v, data, p, row0, gh, halo)
    count_launch(sweep_energy_shard, planes.dtype)
    return out[:4]


sweep_energy_shard.launches = 0
sweep_energy_shard.launches_bf16 = 0
