"""Optimizer iterations over the solve's seconds over the finest level's
Mpx (the reference bench's arithmetic, ``roofline.iters_per_s_per_mpix``):
pairs count every level's ``LevelStats.iters``, the video
``VideoResult.solve_iters`` (cold and warm)."""

from vmbench import roofline
from vmbench.metrics.solve_ms_per_morph import SPANS


def read(r):
    iters, s = sum(r.count("iters")), r.span_s(*SPANS)
    if iters <= 0 or s <= 0:
        return None
    return roofline.iters_per_s_per_mpix(iters, s, int(r.config["height"]), int(r.config["width"]))
