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
from videomorphing_tpu_torch.solver.descent import (
    LevelStats,
    descend,
    foldover_scale,
    level_masks,
    make_level_solver,
    pack_dtype_for,
)
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
    bmask: torch.Tensor    # (bh, W, 2) the frame's boundary lock at the owned rows
    cmasks: tuple          # (bh, W, 1) the frame's colour masks at the owned rows


def _sum_rows(a: np.ndarray) -> np.ndarray:
    """Sum over the blocks in block order, in float32 (the psum)."""
    acc = a[0].copy()
    for row in a[1:]:
        acc = acc + row
    return acc


class _RowBlocks:
    """A row-sharded level's operations for ``descent.descend``: the field
    as owned row blocks ``v_blks``, each block's halo exchange and shard
    kernels, the values gathered in one transfer and summed in block
    order. ``states``: per block (the warp planes, v_lin) of the last
    re-warp; ``v_try``: the extended blocks of the last trial; ``on_card``:
    every block's sweeps launch the card's kernels."""

    def __init__(self, p: MorphParams, devs, v: torch.Tensor, data: LevelData, dt: torch.dtype):
        self.p, self.dt, self.home = p, dt, v.device
        self.h, w = v.shape[0], v.shape[1]
        self.bh = bh = self.h // len(devs)
        self.halo = halo = exchange_halo(p)
        self.npix, self.c = self.h * w, data.i0.shape[-1]
        bmask, cmasks = level_masks(self.h, w, p.n_colors, v.dtype, v.device)
        images = {}
        self.blocks: List[_Block] = []
        for k, dev in enumerate(devs):
            rows = slice(k * bh, (k + 1) * bh)
            if dev not in images:
                images[dev] = (data.i0.to(dev).contiguous(), data.i1.to(dev).contiguous())
            maps = [m[rows].to(dev).contiguous() for m in (data.ui_w, data.ui_v, data.tc_w, data.tc_v)]
            self.blocks.append(_Block(dev, k * bh - halo, pack_maps(LevelData(*images[dev], *maps), dt),
                                      bmask[rows].to(dev, copy=True),  # a block holds only its rows
                                      tuple(m[rows].to(dev, copy=True) for m in cmasks)))
        self.v_blks = [v[k * bh:(k + 1) * bh].to(b.dev).contiguous() for k, b in enumerate(self.blocks)]
        self.on_card = all(vb.is_cuda for vb in self.v_blks)

    def _gather(self, vals) -> np.ndarray:
        """Per-block device vectors -> (n_dev, k) float32, one transfer."""
        return torch.stack([x.to(self.home) for x in vals]).cpu().numpy()

    def _energy_at(self, v_ext) -> np.float32:
        parts = [
            sweep_energy_shard(planes, v_lin, ve, b.data, self.p, b.row0, self.h, self.halo)
            for b, (planes, v_lin), ve in zip(self.blocks, self.states, v_ext)
        ]
        return combine_parts(_sum_rows(self._gather(parts)), self.p, self.npix, self.c)

    def relin(self, median: bool) -> None:
        if median:
            # 3x3 median with real neighbour rows at the seams and the
            # frame's own edge row at its top and bottom (the
            # single-device median's edge replication)
            last = len(self.blocks) - 1
            v1 = halo_exchange_rows(self.v_blks, 1)
            med = []
            for k, (b, vb, ve) in enumerate(zip(self.blocks, self.v_blks, v1)):
                top = vb[:1] if k == 0 else ve[:1]
                bot = vb[-1:] if k == last else ve[-1:]
                sl = torch.cat([top, vb, bot], 0)
                med.append(vb + (median3x3(sl)[1:-1] - vb) * b.bmask)
            self.v_blks = med
        v_ext = halo_exchange_rows(self.v_blks, self.halo)
        v_q = v_ext if self.dt == torch.float32 else [quantize_v_lin(ve, self.p) for ve in v_ext]
        self.states = [(halfway_warp_rows(b.data.i0, b.data.i1, vq, b.row0, self.dt), vq)
                       for b, vq in zip(self.blocks, v_q)]

    def iterate(self, color: int, alpha) -> tuple:
        p, halo = self.p, self.halo
        self.v_ext = halo_exchange_rows(self.v_blks, halo)
        ds, vals = [], []
        for b, (planes, v_lin), ve in zip(self.blocks, self.states, self.v_ext):
            parts, grad, precond = sweep_grad_shard(planes, v_lin, ve, b.data, p, b.row0, self.h, halo)
            d = foldover_scale(ve, (-grad / precond) * b.cmasks[color] * b.bmask, p.fold_margin)
            ds.append(d)
            vals.append(torch.cat([parts, torch.sum(grad * d).reshape(1)]))
        tot = _sum_rows(self._gather(vals))
        self.d_ext = halo_exchange_rows(ds, halo)
        return combine_parts(tot[:4], p, self.npix, self.c), f32(tot[4]), self.backtrack(alpha)

    def backtrack(self, alpha) -> np.float32:
        self.v_try = [ve + float(alpha) * de for ve, de in zip(self.v_ext, self.d_ext)]
        return self._energy_at(self.v_try)

    def accept(self) -> None:
        self.v_blks = [vt[self.halo:self.halo + self.bh] for vt in self.v_try]

    def energy(self) -> np.float32:
        return self._energy_at(halo_exchange_rows(self.v_blks, self.halo))

    def field(self) -> torch.Tensor:
        return torch.cat([vb.to(self.home) for vb in self.v_blks], 0)


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
    device. The loop and its ``solve.level`` span are ``descent.descend``'s
    (no ``reads`` counted).

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
    if p.n_colors not in (1, 2, 4):
        raise ValueError(f"n_colors must be 1, 2 or 4, got {p.n_colors}")

    def solve_rows(devs, v: torch.Tensor, data: LevelData):
        n_dev = len(devs)
        h, w = v.shape[0], v.shape[1]
        if h % n_dev or h // n_dev < halo:
            raise ValueError(
                f"{h} rows do not split into {n_dev} blocks of at least {halo} rows"
            )
        dt = torch.float32 if batch_axis is not None else pack_dtype_for(p, h // n_dev, w, devs[0])
        return descend(lambda: _RowBlocks(p, devs, v, data, dt), p, n_iters, h, w)

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
