"""The clip-pair morph [EGSR14]: ``api.morph_clips(..., render=True)``,
with the user's points on frame 0; in a traced run its stages' walls come
from the program's ``utils.profiling.record_phases()``."""

from __future__ import annotations

import contextlib

from vmbench import compare, inputs
from vmbench.kinds.pair import params, points

PHASES = ("flows", "tracking", "cold_solve", "warm_loop", "bulges", "confidences", "render")


def pool_inputs(config: dict, mix: dict, seed: int, item: int, device) -> tuple:
    """Pool item ``item``'s clip pair (T, H, W, 3) on ``device``."""
    s = inputs.item_seeds(seed, int(mix["pool"]))[item]
    return inputs.make_clips(int(config["frames"]), int(config["height"]), int(config["width"]), s, device)


class Program:
    span_names = PHASES

    def __init__(self, config: dict, mix: dict, seed: int, device):
        from videomorphing_tpu_torch.config import MorphParams, SynthParams, VideoParams

        self.params = params((MorphParams, SynthParams, VideoParams), config)
        self.pool = [pool_inputs(config, mix, seed, i, device) for i in range(int(mix["pool"]))]
        self.points = points(config, mix, device)
        self.device = device

    def morph(self, item: int, spans) -> dict:
        from videomorphing_tpu_torch import api
        from videomorphing_tpu_torch.utils import profiling

        clip_a, clip_b = self.pool[item]
        mp, sp, vp = self.params
        with (profiling.record_phases() if spans.on else contextlib.nullcontext({})) as phases:
            res = api.morph_clips(clip_a, clip_b, self.points, mp=mp, sp=sp, vp=vp, render=True, device=self.device)
        walls = {k: v for k, v in phases.items() if k in PHASES}
        return {"frames": int(res.frames.shape[0]), "counts": {"iters": int(res.solve_iters)},
                "phases": walls, "outputs": {"v": res.fields, "frames": res.frames}}

    def release(self) -> None:
        self.pool = None


def check(config: dict, mix: dict, seed: int, device, item: int, outputs: dict) -> dict:
    """The cold solve of frame 0, which starts the loop: the energy of the
    program's field of frame 0 against that of the reference's own cold
    solve of frame 0 from the same frames and tracked points, both worked
    out by the reference at full resolution with the warps taken at the
    field. The warm loop, step by step from the program's own fields: the
    reference's flows and tracked points from the same clips, and for every
    frame t >= 1 the reference's warm solve started from the program's
    field of frame t - 1, against the program's field of frame t. The
    synthesis: the reference's frames rendered from the program's fields
    against the program's."""
    from vmbench.reference import full_float32
    from vmbench.reference.config import MorphParams, SynthParams, VideoParams
    from vmbench.reference.solver.ctf import field_energy, optimize_pair
    from vmbench.reference.video.pipeline import flows_and_tracks, render_frames, warm_steps

    full_float32()
    mp, sp, vp = params((MorphParams, SynthParams, VideoParams), config)
    clip_a, clip_b = pool_inputs(config, mix, seed, item, device)
    flows, tracked = flows_and_tracks(clip_a, clip_b, points(config, mix, device), vp)
    v = outputs["v"].to(device)
    v0 = optimize_pair(clip_a[0], clip_b[0], points=tracked[0], params=mp).v
    cold = compare.rel_gap(field_energy(clip_a[0], clip_b[0], v[0], tracked[0], mp),
                           field_energy(clip_a[0], clip_b[0], v0, tracked[0], mp))
    del v0
    steps = warm_steps(clip_a, clip_b, v, tracked, flows, mp, vp)
    warm = compare.field_gap_px(v[1:], steps)
    del steps
    ref = render_frames(clip_a, clip_b, v, flows, sp, vp)
    return {"field_energy_gap": cold, "warm_step_gap_px": warm, "frame_gap": compare.frame_gap(outputs["frames"], ref)}
