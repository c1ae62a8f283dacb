#!/usr/bin/env python3
"""Stage walls, launch counts and output digest of the layered pair path
(``chip_smoke.py`` phase 7) for one checkout of the port, on one CUDA card.

    python3 scripts/time_torch_layered_pair.py [--root DIR] [--label NAME] [--runs N]
                                               [--save FRAMES.npy] [--against FRAMES.npy] [--perturb]

Imports ``videomorphing_tpu_torch`` from ``DIR`` (default: this checkout;
an unpacked older commit builds its own kernels into its own ``build/``),
and the inputs and helpers from this checkout (``chip_smoke.py``,
``utils/synthetic.py``, loaded by path), so two commits run the same
work: run it for each, in turns, in one call. The process first runs
``api.morph_pair`` on the same pair once (kernels built, CUDA libraries
loaded, as phase 7 finds them after phases 3-6; its wall is phase 3's
pair_1k, the first call in a process, and is printed as ``pair_1k_s``),
then
``api.morph_pair_layered`` on the 1024 x 1024 pair with one layer on the
blob's disc, 16 frames, ``N`` times (default 2). For each run it prints one
JSON line: the wall (host clock, ending in a synchronize), the stage walls
(background solve, layer solve, bulges and rendering; each stage ends in a
synchronize, timed by wrapping the module's functions), every kernel's
launch count, the iterations per level of both solves and a SHA-256 of the
frames' bytes. ``--save`` writes the last run's frames as a ``.npy``;
``--against`` adds the max and mean absolute difference of each run's
frames from such a file (another checkout's, for instance); ``--perturb``
moves every input pixel up by one float32 ulp, to measure how far the
path itself moves its frames under rounding-level noise. The last line
is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE, help="checkout whose videomorphing_tpu_torch is run")
    ap.add_argument("--label", default=None)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--save", default=None, help="write the last run's frames here (.npy)")
    ap.add_argument("--against", default=None, help="frames (.npy) to compare each run's with")
    ap.add_argument("--perturb", action="store_true", help="inputs one float32 ulp up")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    cs = _load("chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    synthetic = _load("synthetic_clips", os.path.join(HERE, "videomorphing_tpu_torch", "utils", "synthetic.py"))
    if not torch.cuda.is_available():
        print("time_torch_layered_pair: no CUDA device is available", file=sys.stderr)
        return 1
    import videomorphing_tpu_torch
    from videomorphing_tpu_torch import api
    from videomorphing_tpu_torch.kernels import sweep as ks
    from videomorphing_tpu_torch.kernels import warp as kw
    from videomorphing_tpu_torch.models import layered

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(videomorphing_tpu_torch.__file__)))
    if pkg != root:
        raise RuntimeError(f"imported the port from {pkg}, not {root}")
    dev = torch.device("cuda")
    n, n_frames = 1024, 16
    clip_a, clip_b = synthetic.make_clips(1, n, n, seed=0)
    i0, i1, pts = clip_a[0], clip_b[0], cs.bench_points(n, n)
    if args.perturb:
        i0, i1 = (np.nextafter(a, np.float32(np.inf)) for a in (i0, i1))
    layer = dict(mask0=cs.blob_discs(1, n, n, 0.45 * n, dev)[0], mask1=cs.blob_discs(1, n, n, 0.55 * n, dev)[0])
    counters = [getattr(ks, k, None) or getattr(kw, k, None) for k in cs.KERNELS]

    stages: dict = {}
    solves: list = []

    def timed(name, fn):
        def wrapper(*a, **kw_):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw_)
            torch.cuda.synchronize()
            stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    opt = layered.optimize_pair

    def optimize_pair(*a, **kw_):
        name = "solve_bg" if not solves else "solve_layer"
        res = timed(name, opt)(*a, **kw_)
        solves.append([s.iters for s in res.level_stats])
        return res

    layered.optimize_pair = optimize_pair
    layered.bulge_field = timed("bulges", layered.bulge_field)
    layered.render_layered = timed("render", layered.render_layered)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    api.morph_pair(i0, i1, pts, n_frames=n_frames, device=dev)
    torch.cuda.synchronize()
    pair_s = time.perf_counter() - t0
    label = args.label or root
    ref = np.load(args.against) if args.against else None
    for run in range(args.runs):
        stages.clear()
        solves.clear()
        for fn in counters:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = api.morph_pair_layered(i0, i1, [layer], pts, n_frames=n_frames, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out = frames.cpu().numpy()
        rec = {
            "label": label, "run": run, "pair_1k_s": pair_s, "wall_s": wall, "stages_s": stages,
            "launches": {k: fn.launches for k, fn in zip(cs.KERNELS, counters)},
            "iters": solves, "frames_sha256": hashlib.sha256(out.tobytes()).hexdigest(),
        }
        if ref is not None:
            d = np.abs(out.astype(np.float64) - ref)
            rec["vs_against"] = {"max_abs": float(d.max()), "mean_abs": float(d.mean())}
        print(json.dumps(rec), flush=True)
    if args.save:
        np.save(args.save, out)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
