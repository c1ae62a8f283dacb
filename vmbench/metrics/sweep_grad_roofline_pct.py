"""Kernel 1's share of its roofline (%): the least time the solve's
gradient passes need (one ``sweep_grad`` a solver iteration, so each
level's ``LevelStats.iters`` passes over its H x W, each bounded by
``roofline.sweep_grad_bound_s``) over the device time of kernel 1's
launches (``kernel_names/sweep_grad.txt`` and the reduce after each) in
the trace."""

from vmbench import roofline


def read(r):
    levels = [lv for morph in r.count("level_iters") for lv in morph]
    if not levels or r.trace is None:
        return None
    device_s = r.kernel_seconds("sweep_grad")
    if not device_s:
        return None
    c, k = int(r.config["channels"]), int(r.config["morph"]["ssim_window"])
    need = sum(n * roofline.sweep_grad_bound_s(h, w, c, k) for h, w, n in levels)
    return 100.0 * need / device_s
