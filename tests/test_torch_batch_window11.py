"""The batch step at SSIM's standard window against the plain reference, on
the CPU.

``parallel.batch.make_batch_step`` solves and renders a small seeded pair
(48 x 64, 3 levels, one frame at t = 0.5, no points) at ``ssim_window`` 11,
``ssim_sigma`` 1.5, the setting of the ``pair_4k_w11`` configuration, and
at the default window 5 beside it. ``vmbench/reference`` solves the same
pair from the same inputs (``optimize_pair`` with each level's iterations as
the step ran them), computes the full-resolution energy of both fields
(``field_energy``) and renders the frame from the step's field
(``render_clip``). Compared, as the benchmark's ``kinds.batch.check``
compares them on the card: the field's energy, each level's ``e0`` and
``e_final``, and the frame. The same tolerances hold at both windows, and
a field left stale at the finest level (the field that level started
from) fails them.
"""

import functools

import numpy as np
import pytest
import torch

from videomorphing_tpu_torch.config import MorphParams, SynthParams
from videomorphing_tpu_torch.parallel.batch import make_batch_step
from videomorphing_tpu_torch.parallel.mesh import make_mesh
from videomorphing_tpu_torch.solver import ctf
from vmbench import compare, inputs
from vmbench.reference.config import MorphParams as RefMorphParams
from vmbench.reference.config import SynthParams as RefSynthParams
from vmbench.reference.solver.ctf import field_energy, optimize_pair
from vmbench.reference.synth.paths import bulge_field
from vmbench.reference.synth.render import render_clip

torch.set_num_threads(1)
HW = (48, 64)
SEED = 2**31 + 77
WINDOWS = {11: 1.5, 5: 1.0}
SOLVE = dict(n_levels=3, iters_coarse=40, iters_fine=15)
TIME = 0.5

# On the CPU the step runs the kernels' plain versions, the same float32
# operations as the reference (a frozen copy of that path), so the two
# agree to float32 rounding. The field's energy is a mean over 3,072
# pixels and a level's energies sums of a few thousand terms: 1e-5 leaves
# room for reordered sums (~1e-7) and lies 4,000x under the cell's limit
# on the card (0.04), where the kernels sum in another order, and five
# orders under a stale field (~1). A frame value lies in [0, 1], where a
# float32 ulp is 6e-8.
FIELD_ENERGY_TOL = 1e-5
LEVEL_ENERGY_TOL = 1e-5
FRAME_TOL = 1e-6


@functools.lru_cache(maxsize=None)
def _gaps(window: int) -> dict:
    """The step's gaps to the reference at ``window``, and the finest
    level's start field's energy gap (``stale``)."""
    kw = dict(SOLVE, ssim_window=window, ssim_sigma=WINDOWS[window])
    a, b = inputs.make_clips(1, *HW, SEED, "cpu")
    i0, i1 = a[0], b[0]
    started = []
    make_level_solver = ctf.make_level_solver

    def recorded(p, n):
        solve = make_level_solver(p, n)
        return lambda v, data: started.append(v.clone()) or solve(v, data)

    step = make_batch_step(MorphParams(**kw), SynthParams(), make_mesh((1,), ("batch",), devices=["cpu"]), HW, 1)
    results = []
    ctf.make_level_solver = recorded
    try:
        frames = step(i0[None], i1[None], torch.zeros((1, 0, 2, 2)), np.full((1, 1), TIME, np.float32),
                      results=results)
    finally:
        ctf.make_level_solver = make_level_solver
    res = results[0]
    mp, sp = RefMorphParams(**kw), RefSynthParams()
    pts = torch.zeros((0, 2, 2))
    ref = optimize_pair(i0, i1, points=pts, params=mp, min_iters=[int(s.iters) for s in res.level_stats])
    e_ref = field_energy(i0, i1, ref.v, pts, mp)
    ref_frame = render_clip(i0, i1, res.v, bulge_field(res.v, sp), np.array([TIME], np.float32), sp)
    assert len(ref.level_stats) == len(res.level_stats) == 3 and len(started) == 3
    return {
        "iters": [(int(s.iters), int(r.iters)) for s, r in zip(res.level_stats, ref.level_stats)],
        "field_energy": compare.rel_gap(field_energy(i0, i1, res.v, pts, mp), e_ref),
        "level_energy": compare.worst(compare.rel_gap(getattr(s, k), getattr(r, k))
                                      for s, r in zip(res.level_stats, ref.level_stats) for k in ("e0", "e_final")),
        "frame": compare.frame_gap(frames[0], ref_frame),
        "stale": compare.rel_gap(field_energy(i0, i1, started[-1], pts, mp), e_ref),
    }


@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_batch_step_matches_the_reference(window):
    g = _gaps(window)
    assert all(n == m > 0 for n, m in g["iters"]), g["iters"]
    assert g["field_energy"] <= FIELD_ENERGY_TOL, g
    assert g["level_energy"] <= LEVEL_ENERGY_TOL, g
    assert g["frame"] <= FRAME_TOL, g


@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_a_stale_finest_field_fails_the_tolerance(window):
    assert _gaps(window)["stale"] > FIELD_ENERGY_TOL * 1e4
