#!/usr/bin/env python3
"""Times of the PyTorch port's hand-written kernels at the main paths'
shapes, on one CUDA card, for one checkout of the port.

    python3 scripts/time_torch_kernels.py [--root DIR] [--label NAME] [--only K1,K2] [--window K]
                                          [--pack-dtype bfloat16]

Imports ``videomorphing_tpu_torch`` from ``DIR`` (default: this checkout;
an unpacked older commit builds its own kernels into its own ``build/``)
and the timing helpers from this checkout's ``chip_smoke.py``, so two
commits are timed the same way: run it for each, in turns, in one call.
For every kernel and shape it prints one JSON line with

- ``device_ms``: the kernel's device time, its host work excluded
  (``chip_smoke.graph_ms``: calls captured in a CUDA graph, events around
  the replays), two readings;
- ``call_ms``: CUDA events around one wrapper call (``chip_smoke.cuda_ms``,
  the method of the port's earlier kernel records), which counts the
  wrapper's host work before its launch;
- for kernel 4 the same two times of ``F.grid_sample`` on the same inputs;
- the bound of ``chip_smoke.bound``;
- ``window``, and ``digest``: a SHA-256 of one call's outputs (bytes of
  every returned tensor), so two checkouts' kernels can be held to
  bitwise equal outputs on the same inputs.

The shapes: kernel 4 at the path inversion's 1024^2, C = 4, the flow
warps' 58 x 540 x 960 x 1 and the render's 2 x 1080 x 1920 x 4; kernels 1-2
at 1024^2 and 1080 x 1920 (C = 3, default parameters); their shard forms on
block 1 of 4 row blocks of 2160 x 3840; kernel 3 at 1024^2. Kernels 1-2
and their shard forms run at ``ssim_window`` K (default 5, the default
parameters; other windows take ``chip_smoke.WINDOW_SIGMA``'s sigma), the
block's halo following the window. With ``--pack-dtype bfloat16`` each
of kernels 1-2 and their shard forms is also timed in its bf16 form
(``<name>_bf16``: bf16 planes and maps, ``v_lin`` rounded to bf16, as
``chip_smoke.py``'s phase 2 makes them), right after its float32 twin on
the same pixels. The last line is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE, help="checkout whose videomorphing_tpu_torch is timed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--only", default="", help="comma-separated kernel names to time (default: all)")
    ap.add_argument("--window", type=int, default=5, help="ssim_window of kernels 1-2 (default 5)")
    ap.add_argument("--pack-dtype", choices=("float32", "bfloat16"), default="float32",
                    help="bfloat16: also time the bf16 forms of kernels 1-2 and their shard forms")
    args = ap.parse_args()
    only = set(filter(None, args.only.split(",")))
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import importlib.util

    import torch

    # this checkout's helpers, whichever checkout's port is timed
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    if not torch.cuda.is_available():
        print("time_torch_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    from videomorphing_tpu_torch.config import MorphParams
    from videomorphing_tpu_torch.kernels import sweep as ks
    from videomorphing_tpu_torch.kernels import warp as kw
    from videomorphing_tpu_torch.parallel.spatial import exchange_halo
    from videomorphing_tpu_torch.solver.energy import LevelData, make_level_data

    import videomorphing_tpu_torch

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(videomorphing_tpu_torch.__file__)))
    if pkg != root:
        raise RuntimeError(f"imported the port from {pkg}, not {root}")
    label = args.label or root
    dev = torch.device("cuda")
    BF16 = torch.bfloat16
    bf16 = args.pack_dtype == "bfloat16"
    p = MorphParams() if args.window == MorphParams().ssim_window else MorphParams(
        ssim_window=args.window, ssim_sigma=cs.WINDOW_SIGMA.get(args.window, 1.5))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    def digest(out) -> str:
        h = hashlib.sha256()
        for x in out if isinstance(out, (tuple, list)) else (out,):
            h.update(x.detach().contiguous().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    def emit(kernel, shape, fn, nbytes, ops, library=None):
        if only and kernel not in only:
            return
        rec = {"label": label, "kernel": kernel, "shape": shape, "window": args.window, "digest": digest(fn()),
               "device_ms": [cs.graph_ms(fn, 10), cs.graph_ms(fn, 10)], "call_ms": cs.cuda_ms(fn, 10)}
        rec["bound_ms"], rec["bound_by"] = cs.bound(nbytes, ops)
        if library is not None:
            rec["library_device_ms"] = cs.graph_ms(library, 10)
            rec["library_call_ms"] = cs.cuda_ms(library, 10)
        print(json.dumps(rec), flush=True)

    # kernel 4
    h = w = 1024
    v_lin = t(cs.smooth_field(h, w, 20.0, 1))
    g = t(np.stack(np.mgrid[0:h, 0:w], -1))
    stacked = torch.cat([v_lin * -0.5, v_lin], -1).contiguous()
    p_co = (g + 0.5 * v_lin).contiguous()
    npx = h * w
    emit("bilinear_sample", "1024x1024x4", lambda: kw.bilinear_sample(stacked, p_co),
         4 * npx * (4 + 2 + 4), npx * cs.sample_ops_per_pixel(4), cs.grid_sample_call(stacked[None], p_co[None]))
    rng = np.random.default_rng(5)
    for n, (hh, ww), c in ((58, (540, 960), 1), (2, (1080, 1920), 4)):
        gg = t(np.stack(np.mgrid[0:hh, 0:ww], -1))
        imgs = torch.stack([t(255.0 * rng.random((hh, ww, c), dtype=np.float32)) for _ in range(n)])
        coords = torch.stack([gg + t(cs.smooth_field(hh, ww, 3.0, 10 + k)) for k in range(n)])
        m = n * hh * ww
        emit("bilinear_sample_batched", f"{n}x{hh}x{ww}x{c}", lambda: kw.bilinear_sample_batched(imgs, coords),
             4 * (imgs.numel() + coords.numel() + m * c), m * cs.sample_ops_per_pixel(c),
             cs.grid_sample_call(imgs, coords))
        del imgs, coords

    # kernels 1-3, whole frames
    c, k = 3, int(p.ssim_window)
    for h, w in ((1024, 1024), (1080, 1920)):
        rng = np.random.default_rng(h + w)
        i0 = t(rng.random((h, w, 3), dtype=np.float32))
        i1 = t(rng.random((h, w, 3), dtype=np.float32))
        v_lin = t(cs.smooth_field(h, w, 20.0, 1))
        v = t(cs.smooth_field(h, w, 20.0, 1) + cs.smooth_field(h, w, 0.5, 2))
        data = make_level_data(
            i0, i1, t(rng.random((h, w, 1), dtype=np.float32)),
            v + t(0.1 * rng.standard_normal((h, w, 2)).astype(np.float32)),
            t(rng.random((h, w, 1), dtype=np.float32)),
            v + t(0.5 * rng.standard_normal((h, w, 2)).astype(np.float32)),
        )
        planes = kw.halfway_warp(i0, i1, v_lin)
        npx, shape = h * w, f"{h}x{w}"
        if h == 1024:
            emit("halfway_warp", shape, lambda: kw.halfway_warp(i0, i1, v_lin),
                 4 * npx * (2 * c + 2 + 6 * c), npx * cs.warp_ops_per_pixel(c))
        # the float32 forms, then (--pack-dtype bfloat16) the bf16 forms on the same pixels
        forms = [("", planes, v_lin, data, 4)]
        if bf16:
            vq = v_lin.to(BF16).float()
            forms.append(("_bf16", kw.halfway_warp(i0, i1, vq, BF16), vq, ks.pack_maps(data, BF16), 2))
        for with_grad in (True, False):
            for sfx, pl, vl, dt, pb in forms:
                fn = ks.sweep_grad if with_grad else ks.sweep_energy
                emit(("sweep_grad" if with_grad else "sweep_energy") + sfx, shape,
                     lambda fn=fn, pl=pl, vl=vl, dt=dt: fn(pl, vl, v, dt, p),
                     npx * cs.sweep_bytes(c, with_grad, pb), npx * cs.sweep_ops_per_pixel(c, k, with_grad))
        del planes, data, forms

    # shard forms: block 1 of 4 row blocks of 2160 x 3840, with its halo
    h, w = 2160, 3840
    rng = np.random.default_rng(h + w + 1)
    i0 = t(rng.random((h, w, 3), dtype=np.float32))
    i1 = t(rng.random((h, w, 3), dtype=np.float32))
    v_lin = t(cs.smooth_field(h, w, 20.0, 5))
    v = v_lin + t(cs.smooth_field(h, w, 0.5, 6))
    data = make_level_data(
        i0, i1, t(rng.random((h, w, 1), dtype=np.float32)),
        v + t(0.1 * rng.standard_normal((h, w, 2)).astype(np.float32)),
        t(rng.random((h, w, 1), dtype=np.float32)),
        v + t(0.5 * rng.standard_normal((h, w, 2)).astype(np.float32)),
    )
    halo = exchange_halo(p)
    _, row0, rows = cs._blocks(h, 4, halo)[1]
    bh = rows.stop - rows.start
    he = bh + 2 * halo
    vl_e, v_e = cs._ext(v_lin, row0, he), cs._ext(v, row0, he)
    data_k = LevelData(i0, i1, *(a[rows].contiguous() for a in (data.ui_w, data.ui_v, data.tc_w, data.tc_v)))
    pl_k = kw.halfway_warp_rows(i0, i1, vl_e, row0)
    shape = f"{he}x{w} block"
    emit("halfway_warp_rows", shape, lambda: kw.halfway_warp_rows(i0, i1, vl_e, row0),
         4 * he * w * (2 * c + 2 + 6 * c), he * w * cs.warp_ops_per_pixel(c))
    # the extended block's planes, v and v_lin; the owned rows' maps (and grad, precond)
    forms = [("", pl_k, vl_e, data_k, 4)]
    if bf16:
        vq_e = vl_e.to(BF16).float()
        forms.append(("_bf16", kw.halfway_warp_rows(i0, i1, vq_e, row0, BF16), vq_e, ks.pack_maps(data_k, BF16), 2))
    for with_grad in (True, False):
        for sfx, pl, vl, dt, pb in forms:
            fn = ks.sweep_grad_shard if with_grad else ks.sweep_energy_shard
            emit(("sweep_grad_shard" if with_grad else "sweep_energy_shard") + sfx, shape,
                 lambda fn=fn, pl=pl, vl=vl, dt=dt: fn(pl, vl, v_e, dt, p, row0, h, halo),
                 he * w * (pb * 6 * c + 16) + bh * w * (pb * 6 + (16 if with_grad else 0)),
                 bh * w * cs.sweep_ops_per_pixel(c, k, with_grad))
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
