"""Row-sharded level solve: one large frame's rows across the mesh.

Port of ``videomorphing_tpu/parallel/spatial.py``. The halfway field and
the per-pixel maps are split by ROWS over a mesh axis, the source images are
replicated (a 4K float32 pair is ~200 MB), and the only traffic between the
blocks is

- the halo exchange (``parallel.halo``) of a few field rows per iteration;
- the energy partials and the directional derivative, summed over the
  blocks in block order on the host for the shared line search.

Each block extends its rows by ``2 (window // 2) + 2`` real neighbour rows
(zero rows beyond the frame) and runs the row-shard kernels on them: the
row-offset halfway warp once per relinearization and the shard forms of the
sweep kernels per iteration and per Armijo trial (``kernels/``). With the
global-row checkerboard and boundary masks, each iteration computes the
single-device solver's gradient and energy; only the order of the sums
differs.

The loop schedule, the relin median with real neighbour rows (the frame's
own edge row substituted at its top and bottom), the foldover clamp on the
extended block and the Armijo arithmetic (numpy float32 on the host) are
the reference's. The blocks run one after another from this process, so on
a mesh that repeats one card the sharded solve is a correctness path, not a
speed-up. With ``batch_axis`` a 2-D mesh solves a batch of pairs, one
row-sharded solve per pair on its batch block's devices.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from videomorphing_tpu_torch.config import MorphParams
from videomorphing_tpu_torch.kernels.sweep import (
    combine_parts,
    pack_maps,
    quantize_v_lin,
    sweep_energy_shard,
    sweep_grad_shard,
)
from videomorphing_tpu_torch.kernels.warp import halfway_warp_rows
from videomorphing_tpu_torch.ops.windows import median3x3
from videomorphing_tpu_torch.parallel.halo import halo_exchange_rows
from videomorphing_tpu_torch.parallel.mesh import as_mesh, make_mesh
from videomorphing_tpu_torch.solver.descent import LevelStats, _axis_gaps, make_level_solver, pack_dtype_for
from videomorphing_tpu_torch.solver.energy import LevelData

f32 = np.float32


def exchange_halo(p: MorphParams) -> int:
    """Rows exchanged with each neighbour: the SSIM transposed window's
    reach plus the TPS stencil's (the reference's ``2 (window // 2) + 2``)."""
    return 2 * (int(p.ssim_window) // 2) + 2


def level_is_sharded(lh: int, n_dev: int, p: MorphParams, min_rows_per_device: int = 8) -> bool:
    """The reference's rule: a level is row-sharded when its height divides
    the mesh axis and every block has at least ``min_rows_per_device`` rows
    and a full halo; the other levels solve on one device."""
    halo = exchange_halo(p)
    return n_dev > 1 and lh % n_dev == 0 and lh // n_dev >= max(min_rows_per_device, halo)


class _Block(NamedTuple):
    dev: torch.device
    row0: int              # global row of the extended block's first row
    data: LevelData        # replicated images, the owned rows' maps
    parity: torch.Tensor   # (bh, W) checkerboard colour of each owned pixel
    bmask: torch.Tensor    # (bh, W, 2) boundary lock in global coordinates


def _parity(ys: torch.Tensor, xs: torch.Tensor, n_colors: int) -> torch.Tensor:
    if n_colors == 2:
        return (ys[:, None] + xs[None, :]) % 2
    if n_colors == 4:
        return (ys[:, None] % 2) * 2 + (xs[None, :] % 2)
    if n_colors == 1:
        return torch.zeros((ys.shape[0], xs.shape[0]), dtype=ys.dtype, device=ys.device)
    raise ValueError(f"n_colors must be 1, 2 or 4, got {n_colors}")


def _foldover_scale_ext(v_ext: torch.Tensor, d: torch.Tensor, halo: int, margin: float) -> torch.Tensor:
    """``descent.foldover_scale`` with the neighbour gaps taken on the
    extended block (a block-edge gap needs the neighbour's row)."""
    bh = d.shape[0]
    m_y = _axis_gaps(v_ext[..., 0], 0)[halo:halo + bh]
    m_x = _axis_gaps(v_ext[..., 1], 1)[halo:halo + bh]
    s_y = torch.clamp(margin * m_y / (torch.abs(d[..., 0]) + 1e-12), max=1.0)
    s_x = torch.clamp(margin * m_x / (torch.abs(d[..., 1]) + 1e-12), max=1.0)
    return torch.stack([d[..., 0] * s_y, d[..., 1] * s_x], dim=-1)


def _sum_rows(a: np.ndarray) -> np.ndarray:
    """Sum over the blocks in block order, in float32 (the psum)."""
    acc = a[0].copy()
    for row in a[1:]:
        acc = acc + row
    return acc


def make_spatial_level_solver(
    p: MorphParams,
    n_iters: int,
    mesh,
    axis: str = "y",
    batch_axis: Optional[str] = None,
):
    """The row-sharded counterpart of ``solver.descent.make_level_solver``:
    ``solve(v, data) -> (v', LevelStats)`` with ``v`` and ``data`` whole
    frames on one device; the frame's H must divide the axis size and leave
    every block at least the exchange halo. The result lands on ``v``'s
    device.

    With ``batch_axis`` (the reference's pairs x rows layout on a 2-D
    mesh), every input carries a leading batch dimension B that divides
    over ``mesh.shape[batch_axis]``: pair i goes to batch block
    ``i // (B // n_batch)`` and runs the row-sharded solve on that block's
    devices along ``axis`` (``Mesh.devices_along``). ``v'`` is
    (B, H, W, 2) and every ``LevelStats`` field is stacked over B (CPU
    tensors). The reference ``vmap``s its loop, freezing the carry of a
    pair that has stopped, so each pair's result, ``iters`` included, is
    its independent solve's: a loop over the pairs gives the same. The
    reference keeps this layout on its jnp backend (a vmap of a
    ``pallas_call`` risked Mosaic's compiler); the port has no such risk
    and runs the shard kernels here too.

    The sweeps' pack dtype follows ``descent.pack_dtype_for`` on a block's
    owned rows (the reference's ``_resolve_backend(p, bh, w)``), with the
    linearization point rounded to it before each re-warp; with
    ``batch_axis`` it is float32, as the reference keeps that layout off
    its Pallas path.
    """
    mesh = as_mesh(mesh)
    halo = exchange_halo(p)
    armijo_c, shrink, grow = f32(p.armijo_c), f32(p.step_shrink), f32(p.step_grow)
    min_step, tol = f32(p.min_step), f32(p.tol)
    if p.n_colors not in (1, 2, 4):
        raise ValueError(f"n_colors must be 1, 2 or 4, got {p.n_colors}")

    def solve_rows(devs, v: torch.Tensor, data: LevelData):
        n_dev = len(devs)
        h, w = v.shape[0], v.shape[1]
        if h % n_dev or h // n_dev < halo:
            raise ValueError(
                f"{h} rows do not split into {n_dev} blocks of at least {halo} rows"
            )
        bh = h // n_dev
        dt = torch.float32 if batch_axis is not None else pack_dtype_for(p, bh, w, devs[0])
        home = v.device
        c = data.i0.shape[-1]
        npix = h * w
        images = {}
        blocks: List[_Block] = []
        for k, dev in enumerate(devs):
            rows = slice(k * bh, (k + 1) * bh)
            if dev not in images:
                images[dev] = (data.i0.to(dev).contiguous(), data.i1.to(dev).contiguous())
            maps = [m[rows].to(dev).contiguous() for m in (data.ui_w, data.ui_v, data.tc_w, data.tc_v)]
            ys = torch.arange(k * bh, (k + 1) * bh, device=dev)
            xs = torch.arange(w, device=dev)
            bmask = torch.ones((bh, w, 2), dtype=v.dtype, device=dev)
            bmask[..., 0] = ((ys != 0) & (ys != h - 1)).to(v.dtype)[:, None]
            bmask[..., 1] = ((xs != 0) & (xs != w - 1)).to(v.dtype)[None, :]
            blocks.append(_Block(dev, k * bh - halo, pack_maps(LevelData(*images[dev], *maps), dt),
                                 _parity(ys, xs, p.n_colors), bmask))
        v_blks = [v[k * bh:(k + 1) * bh].to(b.dev).contiguous() for k, b in enumerate(blocks)]

        def gather(vals) -> np.ndarray:
            """Per-block device vectors -> (n_dev, k) float32, one transfer."""
            return torch.stack([x.to(home) for x in vals]).cpu().numpy()

        def energy_at(states, v_ext) -> np.float32:
            parts = [
                sweep_energy_shard(planes, v_lin, ve, b.data, p, b.row0, h, halo)
                for b, (planes, v_lin), ve in zip(blocks, states, v_ext)
            ]
            return combine_parts(_sum_rows(gather(parts)), p, npix, c)

        def warp_states(v_ext):
            """Per block (the warp planes, v_lin) of a re-warp at ``v_ext``."""
            v_q = v_ext if dt == torch.float32 else [quantize_v_lin(ve, p) for ve in v_ext]
            return [(halfway_warp_rows(b.data.i0, b.data.i1, vq, b.row0, dt), vq) for b, vq in zip(blocks, v_q)]

        hist = torch.full((max(n_iters, 0),), float("nan"), dtype=torch.float32)
        if n_iters <= 0:
            v_ext = halo_exchange_rows(v_blks, halo)
            e0 = energy_at(warp_states(v_ext), v_ext)
            return v, LevelStats(e0=float(e0), e_final=float(e0), iters=0,
                                 step=float(f32(p.init_step)), energy_history=hist)

        relin = max(int(p.relin_every), 1)
        step, e, e0 = f32(p.init_step), f32(0.0), f32(0.0)
        stall, it = 0, 0

        def cond():
            return it < n_iters and stall <= p.n_colors and step > min_step

        while cond():
            it0 = it
            if p.relin_median and it0 > 0:
                # 3x3 median with real neighbour rows at the seams and the
                # frame's own edge row at its top and bottom (the
                # single-device median's edge replication)
                v1 = halo_exchange_rows(v_blks, 1)
                med = []
                for k, (b, vb, ve) in enumerate(zip(blocks, v_blks, v1)):
                    top = vb[:1] if k == 0 else ve[:1]
                    bot = vb[-1:] if k == n_dev - 1 else ve[-1:]
                    sl = torch.cat([top, vb, bot], 0)
                    med.append(vb + (median3x3(sl)[1:-1] - vb) * b.bmask)
                v_blks = med
            states = warp_states(halo_exchange_rows(v_blks, halo))
            while cond() and it < it0 + relin:
                v_ext = halo_exchange_rows(v_blks, halo)
                ds, vals = [], []
                for b, (planes, v_lin), ve in zip(blocks, states, v_ext):
                    parts, grad, precond = sweep_grad_shard(planes, v_lin, ve, b.data, p, b.row0, h, halo)
                    cmask = (b.parity == it % p.n_colors).to(v.dtype)[..., None]
                    d = (-grad / precond) * cmask * b.bmask
                    d = _foldover_scale_ext(ve, d, halo, p.fold_margin)
                    ds.append(d)
                    vals.append(torch.cat([parts, torch.sum(grad * d).reshape(1)]))
                tot = _sum_rows(gather(vals))
                e_cur = combine_parts(tot[:4], p, npix, c)
                gd = f32(tot[4])
                if it == 0:
                    e0 = e_cur
                d_ext = halo_exchange_rows(ds, halo)

                def trial(alpha):
                    v_try = [ve + float(alpha) * de for ve, de in zip(v_ext, d_ext)]
                    return v_try, energy_at(states, v_try)

                alpha = step
                v_try, e_try = trial(alpha)
                tries = 0
                while (e_try > e_cur + armijo_c * alpha * gd and tries < p.max_backtracks
                       and alpha > min_step):
                    alpha = alpha * shrink
                    v_try, e_try = trial(alpha)
                    tries += 1
                accepted = e_try <= e_cur + armijo_c * alpha * gd
                if accepted:
                    v_blks = [vt[halo:halo + bh] for vt in v_try]
                    e_new = e_try
                    step = alpha * grow if tries == 0 else alpha
                else:
                    e_new = e_cur
                    step = alpha * shrink
                rel_dec = (e_cur - e_new) / np.maximum(np.abs(e_cur), f32(1e-12))
                stall = stall + 1 if rel_dec < tol else 0
                hist[it] = float(e_new)
                e = e_new
                it += 1

        v_out = torch.cat([vb.to(home) for vb in v_blks], 0)
        return v_out, LevelStats(e0=float(e0), e_final=float(e), iters=it, step=float(step),
                                 energy_history=hist)

    if batch_axis is None:
        devs = mesh.axis_devices(axis)
        return lambda v, data: solve_rows(devs, v, data)
    if batch_axis == axis or batch_axis not in mesh.shape:
        raise ValueError(f"batch_axis {batch_axis!r} must be another axis of {mesh.axis_names}")
    n_batch = mesh.shape[batch_axis]
    row_devs = [mesh.devices_along(axis, batch_axis, k) for k in range(n_batch)]

    def solve_batch(v: torch.Tensor, data: LevelData):
        bsz = v.shape[0]
        if bsz % n_batch:
            raise ValueError(f"a batch of {bsz} pairs does not divide over {n_batch} batch blocks")
        per = bsz // n_batch
        outs = [solve_rows(row_devs[i // per], v[i], LevelData(*(x[i] for x in data))) for i in range(bsz)]
        stats = [st for _, st in outs]
        column = lambda name, dtype: torch.tensor([getattr(st, name) for st in stats], dtype=dtype)
        return torch.stack([vi for vi, _ in outs]), LevelStats(
            e0=column("e0", torch.float32), e_final=column("e_final", torch.float32),
            iters=column("iters", torch.int32), step=column("step", torch.float32),
            energy_history=torch.stack([st.energy_history for st in stats]),
        )

    return solve_batch


def _as_tensor(x, device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x, np.float32))
    return t.to(device=device, dtype=torch.float32).contiguous()


def optimize_pair_spatial(
    i0,
    i1,
    points=None,
    params: MorphParams = MorphParams(),
    mesh=None,
    axis: str = "y",
    min_rows_per_device: int = 8,
):
    """Coarse-to-fine solve of ONE large frame pair with its rows sharded.

    The levels that :func:`level_is_sharded` admits run the row-sharded
    solver; the small coarse levels run the single-device solver on the
    mesh's first device, where the inputs are moved and the result lands.
    ``mesh`` defaults to every visible card on ``axis`` (raises without
    one; one card solves every level locally). Returns a
    ``solver.ctf.OptimizeResult``.
    """
    from videomorphing_tpu_torch.ops.pyramid import (
        auto_n_levels,
        gaussian_pyramid,
        pyramid_shapes,
        upsample_field_2x,
    )
    from videomorphing_tpu_torch.solver.constraints import rasterize_point_constraints, scale_points
    from videomorphing_tpu_torch.solver.ctf import OptimizeResult
    from videomorphing_tpu_torch.solver.energy import make_level_data

    mesh = as_mesh(make_mesh(axis_names=(axis,)) if mesh is None else mesh)
    home = mesh.axis_devices(axis)[0]
    i0 = _as_tensor(i0, home)
    i1 = _as_tensor(i1, home)
    h, w = i0.shape[0], i0.shape[1]
    dtype = i0.dtype
    n_levels = params.n_levels or auto_n_levels(h, w, params.min_level_size)
    shapes = pyramid_shapes(h, w, n_levels)
    n_dev = int(mesh.shape[axis])
    points = torch.zeros((0, 2, 2), dtype=dtype, device=home) if points is None else _as_tensor(points, home)

    pyr0 = gaussian_pyramid(i0, n_levels)
    pyr1 = gaussian_pyramid(i1, n_levels)
    v = torch.zeros(shapes[-1] + (2,), dtype=dtype, device=home)
    stats = []
    for level in range(n_levels - 1, -1, -1):
        lh, lw = shapes[level]
        lpts = scale_points(points, (h, w), (lh, lw))
        ui_w, ui_v = rasterize_point_constraints(lpts, (lh, lw), params.ui_sigma, dtype, home)
        data = make_level_data(pyr0[level], pyr1[level], ui_w, ui_v)
        n_iters = params.iters_for_level(level, n_levels)
        if level_is_sharded(lh, n_dev, params, min_rows_per_device):
            solve = make_spatial_level_solver(params, n_iters, mesh, axis)
        else:
            solve = make_level_solver(params, n_iters)
        v, st = solve(v, data)
        stats.append(st)
        if level > 0:
            v = upsample_field_2x(v, shapes[level - 1])
    return OptimizeResult(v=v, level_stats=tuple(stats), n_levels=n_levels)
