"""The image-pair morph [TOG14]: ``ImageMorpher.solve`` then
``ImageMorpher.render`` at the mix's evenly spaced times, as
``api.morph_pair`` runs them, split so that each layer has a span."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vmbench import compare, inputs, roofline


def params(classes, config: dict) -> tuple:
    """The configuration's ``morph`` and ``synth`` sections as instances of
    ``classes`` (the program's or the reference's dataclasses); a field that
    the class lacks is left out."""
    out = []
    for cls, key in zip(classes, ("morph", "synth", "video")):
        names = {f.name for f in dataclasses.fields(cls)}
        out.append(cls(**{k: v for k, v in config.get(key, {}).items() if k in names}))
    return tuple(out)


def pool_inputs(config: dict, mix: dict, seed: int, item: int, device) -> tuple:
    """Pool item ``item``'s image pair (H, W, 3) on ``device``."""
    s = inputs.item_seeds(seed, int(mix["pool"]))[item]
    ca, cb = inputs.make_clips(1, int(config["height"]), int(config["width"]), s, device)
    return ca[0], cb[0]


def points(config: dict, mix: dict, device) -> torch.Tensor:
    return torch.from_numpy(inputs.user_points(int(config["height"]), int(config["width"]),
                                               int(mix["points"]))).to(device)


def times(mix: dict) -> np.ndarray:
    return np.linspace(0.0, 1.0, int(mix["frames"]), dtype=np.float32)


class Program:
    span_names = ("solve", "render")

    def __init__(self, config: dict, mix: dict, seed: int, device):
        from videomorphing_tpu_torch.config import MorphParams, SynthParams
        from videomorphing_tpu_torch.models.image_morph import ImageMorpher

        mp, sp = params((MorphParams, SynthParams), config)
        self.morpher = ImageMorpher(mp, sp, str(device))
        self.pool = [pool_inputs(config, mix, seed, i, device) for i in range(int(mix["pool"]))]
        self.points = points(config, mix, device)
        self.ts = times(mix)
        self.shape = (int(config["height"]), int(config["width"]))

    def morph(self, item: int, spans) -> dict:
        i0, i1 = self.pool[item]
        with spans("solve"):
            art = self.morpher.solve(i0, i1, self.points)
        with spans("render"):
            frames = self.morpher.render(i0, i1, art, self.ts)
        stats = art.result.level_stats  # coarse to fine
        shapes = roofline.pyramid_shapes(*self.shape, art.result.n_levels)[len(stats) - 1::-1]
        counts = {
            "iters": sum(int(s.iters) for s in stats),
            "level_iters": [[h, w, int(s.iters)] for (h, w), s in zip(shapes, stats)],
            "pixels": self.shape[0] * self.shape[1],
        }
        outputs = {"v": art.v, "frames": frames,
                   "levels": [(int(s.iters), float(s.e0), float(s.e_final)) for s in stats]}
        return {"frames": len(self.ts), "counts": counts, "outputs": outputs}

    def release(self) -> None:
        self.pool = None


def check(config: dict, mix: dict, seed: int, device, item: int, outputs: dict) -> dict:
    """The solve: the reference's own coarse-to-fine solve from the same
    inputs, each level run at least as many iterations as the program's
    ``LevelStats`` say it ran. Its output: the energy of the field the
    program returned, against that of the reference's field, both worked
    out by the reference at full resolution with the warps taken at the
    field (the fields themselves part by the float32 noise that the descent
    amplifies: see PERF.md). Its course: at every level the energies that
    both report at its start (``e0``) and end (``e_final``), the program's
    against the reference's. The synthesis: the reference's frames rendered
    from the program's field against the program's."""
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
