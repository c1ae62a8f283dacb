"""Config 5's batch step [EGSR14's batch mode; TOG14's solve and
synthesis]: ``parallel.batch.make_batch_step`` on one card, one pair a
step and one frame at the mix's time. The step hands back its solves
(``results``); in a traced run its phases' walls come from the program's
``utils.profiling.record_phases()``, and its own ``batch.step`` range names
the idle gaps between them."""

from __future__ import annotations

import contextlib

import numpy as np

from vmbench import compare, roofline
from vmbench.kinds.pair import params, points, pool_inputs

PHASES = ("cold_solve", "bulges", "render")


def times(mix: dict) -> np.ndarray:
    """The one time each step renders, (1,)."""
    return np.array([float(mix["time"])], np.float32)


class Program:
    span_names = PHASES + ("batch.step",)

    def __init__(self, config: dict, mix: dict, seed: int, device):
        from videomorphing_tpu_torch.config import MorphParams, SynthParams
        from videomorphing_tpu_torch.parallel.batch import make_batch_step
        from videomorphing_tpu_torch.parallel.mesh import make_mesh

        mp, sp = params((MorphParams, SynthParams), config)
        self.shape = (int(config["height"]), int(config["width"]))
        self.step = make_batch_step(mp, sp, make_mesh((1,), ("batch",), devices=[device]), self.shape, 1)
        self.pool = [pool_inputs(config, mix, seed, i, device) for i in range(int(mix["pool"]))]
        self.points = points(config, mix, device)[None]
        self.ts = times(mix)[None]

    def morph(self, item: int, spans) -> dict:
        from videomorphing_tpu_torch.utils import profiling

        i0, i1 = self.pool[item]
        results = []
        with (profiling.record_phases() if spans.on else contextlib.nullcontext({})) as phases:
            frames = self.step(i0[None], i1[None], self.points, self.ts, results=results)
        res = results[0]
        stats = res.level_stats  # coarse to fine
        shapes = roofline.pyramid_shapes(*self.shape, res.n_levels)[len(stats) - 1::-1]
        counts = {
            "iters": sum(int(s.iters) for s in stats),
            "level_iters": [[h, w, int(s.iters)] for (h, w), s in zip(shapes, stats)],
            "pixels": self.shape[0] * self.shape[1],
        }
        outputs = {"v": res.v, "frames": frames[0],
                   "levels": [(int(s.iters), float(s.e0), float(s.e_final)) for s in stats]}
        walls = {k: v for k, v in phases.items() if k in PHASES}
        return {"frames": int(frames.shape[0] * frames.shape[1]), "counts": counts, "phases": walls,
                "outputs": outputs}

    def release(self) -> None:
        self.pool = None


def check(config: dict, mix: dict, seed: int, device, item: int, outputs: dict) -> dict:
    """``kinds.pair.check`` at the step's one time. The solve: the
    reference's own coarse-to-fine solve from the same inputs, each level
    run at least as many iterations as the program's ``LevelStats`` say it
    ran; the energy of the program's field against that of the reference's,
    both worked out by the reference at full resolution; each level's
    ``e0`` and ``e_final``, the program's against the reference's. The
    synthesis: the reference's frame rendered from the program's field
    against the program's."""
    from vmbench.reference import full_float32
    from vmbench.reference.config import MorphParams, SynthParams
    from vmbench.reference.solver.ctf import field_energy, optimize_pair
    from vmbench.reference.synth.paths import bulge_field
    from vmbench.reference.synth.render import render_clip

    full_float32()
    mp, sp = params((MorphParams, SynthParams), config)
    i0, i1 = pool_inputs(config, mix, seed, item, device)
    levels = outputs["levels"]
    pts = points(config, mix, device)
    res = optimize_pair(i0, i1, points=pts, params=mp, min_iters=[n for n, _, _ in levels])
    ref = res.level_stats
    if len(ref) != len(levels):
        energy = float("inf")
    else:
        energy = compare.worst(compare.rel_gap(e, float(getattr(r, k)))
                               for (_, e0, ef), r in zip(levels, ref) for e, k in ((e0, "e0"), (ef, "e_final")))
    v = outputs["v"].to(device)
    field = compare.rel_gap(field_energy(i0, i1, v, pts, mp), field_energy(i0, i1, res.v, pts, mp))
    del res
    frames = render_clip(i0, i1, v, bulge_field(v, sp) if sp.quadratic_paths else None, times(mix), sp)
    return {"field_energy_gap": field, "level_energy_gap": energy,
            "frame_gap": compare.frame_gap(outputs["frames"], frames)}
