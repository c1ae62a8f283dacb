"""The clip-pair morph [EGSR14] on two takes that drift in lighting:
``api.morph_clips(clip_a, clip_b, {0: points}, ..., render=True)`` on the
stressor takes of ``vmbench.stressor``, with the disk-centre pair on frame
0 and the configuration's flows (the robust flow where it sets
``flow_robust``). The phases, the morph and the numbers compared are the
video kind's; only the inputs differ."""

from __future__ import annotations

import torch

from vmbench import compare, inputs, stressor
from vmbench.kinds import video
from vmbench.kinds.pair import params


def pool_inputs(config: dict, mix: dict, seed: int, item: int, device) -> tuple:
    """Pool item ``item``'s take pair (T, H, W, 3) on ``device`` and its
    points ``{0: (1, 2, 2)}``."""
    s = inputs.item_seeds(seed, int(mix["pool"]))[item]
    content = config["stressor"]
    clip_a, clip_b, pts = stressor.make_takes(int(config["frames"]), int(config["height"]), int(config["width"]),
                                              s, device, drift=float(content["drift"]), edge=float(content["edge"]))
    return clip_a, clip_b, {0: torch.from_numpy(pts).to(device)}


class Program(video.Program):
    def __init__(self, config: dict, mix: dict, seed: int, device):
        from videomorphing_tpu_torch.config import MorphParams, SynthParams, VideoParams

        self.params = params((MorphParams, SynthParams, VideoParams), config)
        items = [pool_inputs(config, mix, seed, i, device) for i in range(int(mix["pool"]))]
        self.pool = [(clip_a, clip_b) for clip_a, clip_b, _ in items]
        self.points = items[0][2]  # the formula's pair, the same for every item
        self.device = device


def check(config: dict, mix: dict, seed: int, device, item: int, outputs: dict) -> dict:
    """The video kind's three numbers (``video.check``) from the item's
    takes and points: frame 0's cold solve against the reference's, the
    warm loop step by step from the program's fields against the
    reference's warm solves on the reference's own flows (robust where the
    configuration says) and tracked points, and the frames against the
    reference's render of the program's fields."""
    from vmbench.reference import full_float32
    from vmbench.reference.config import MorphParams, SynthParams, VideoParams
    from vmbench.reference.solver.ctf import field_energy, optimize_pair
    from vmbench.reference.video.pipeline import flows_and_tracks, render_frames, warm_steps

    full_float32()
    mp, sp, vp = params((MorphParams, SynthParams, VideoParams), config)
    clip_a, clip_b, points = pool_inputs(config, mix, seed, item, device)
    flows, tracked = flows_and_tracks(clip_a, clip_b, points, vp)
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
