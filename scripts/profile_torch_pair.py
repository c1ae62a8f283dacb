#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's pair morph, on one CUDA card.

    python3 scripts/profile_torch_pair.py [--size 1024] [--frames 16] [--reps 3]

Runs ``solve_pair`` + ``render`` (the two halves of ``api.morph_pair``) on
the JAX bench's synthetic pair with 4 points: one warm-up, then ``--reps``
timed runs (host clock, each half ending in ``torch.cuda.synchronize()``),
then one run under ``torch.profiler``. Prints the walls, the device busy
time and idle share of the profiled run (device-side kernel and copy
events only), and the kernels with the most device time.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from videomorphing_tpu_torch import api
    from videomorphing_tpu_torch.device import require_cuda
    from videomorphing_tpu_torch.models.image_morph import ImageMorpher

    dev = require_cuda()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    i0, i1, pts = chip_smoke.make_pair(args.size)
    ti0, ti1 = (torch.from_numpy(x).to(dev) for x in (i0, i1))
    ts = np.linspace(0.0, 1.0, args.frames, dtype=np.float32)
    morpher = ImageMorpher(device=str(dev))

    def run():
        t0 = time.perf_counter()
        art = api.solve_pair(ti0, ti1, pts, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        morpher.render(ti0, ti1, art, ts)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return t1 - t0, t2 - t1, sum(s.iters for s in art.result.level_stats)

    run()  # warm-up: kernel build, allocator, cached matrices
    for r in range(args.reps):
        solve, render, iters = run()
        print(f"rep {r}: solve {solve:.4f} s ({iters} iterations), render {render:.4f} s, "
              f"total {solve + render:.4f} s on {card}", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solve, render, _ = run()
    wall = solve + render
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in kernels) / 1e6
    print(f"profiled: wall {wall:.4f} s (solve {solve:.4f}, render {render:.4f}); "
          f"device busy {busy:.4f} s, idle share {1 - busy / wall:.3f} on {card}")
    for e in sorted(kernels, key=dev_us, reverse=True)[:15]:
        print(f"  {dev_us(e) / 1e3:10.3f} ms  {e.count:6d} calls  {e.key[:100]}")
    host = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.key.startswith("aten::"):
            host[e.key] = host.get(e.key, 0) + e.count
    print(f"host-side aten ops launched: {sum(host.values())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
