"""The strip forms of kernels 1 and 2 against their roofline (%): the least
time the solve's strip passes need over the device time of the strip
launches (``kernel_names/sweep_strips.txt``, each with the reduce after
it) in the trace. The passes are the program's ``solve.level`` counters:
``strip_iters`` gradient passes over the level's h x w, each bounded by
``roofline.sweep_grad_bound_s``, and ``strip_trials`` energy passes, each
bounded by ``roofline.bound_s`` of the energy's bytes and operations per
pixel, both at the level's window 2 ``radius`` + 1. None where no span
carries the counters or no strip kernel ran."""

from vmbench import program_spans, roofline


def read(r):
    levels = [s for s in program_spans.named("solve.level")
              if "strip_iters" in s.counts or "strip_trials" in s.counts]
    if not levels or r.trace is None:
        return None
    device_s = r.kernel_seconds("sweep_strips")
    if not device_s:
        return None
    c = int(r.config["channels"])
    need = 0.0
    for s in levels:
        h, w, k = int(s.attrs["h"]), int(s.attrs["w"]), 2 * int(s.attrs["radius"]) + 1
        energy_s = roofline.bound_s(h * w * roofline.sweep_bytes(c, False, 4),
                                    h * w * roofline.sweep_ops_per_pixel(c, k, False))
        need += (int(s.counts.get("strip_iters", 0)) * roofline.sweep_grad_bound_s(h, w, c, k)
                 + int(s.counts.get("strip_trials", 0)) * energy_s)
    return 100.0 * need / device_s
