#!/usr/bin/env python3
"""The bf16 forms of sweep kernels 1, 1s, 2 and 2s under a memory checker.

    PYTORCH_NO_CUDA_MEMORY_CACHING=1 compute-sanitizer --tool memcheck \\
        python3 scripts/memcheck_bf16_sweeps.py

Runs each bf16 form once, with a synchronize after each call, on
``chip_smoke.py`` phase 2's bf16 shapes (135 x 241 and ``BF16_PARITY_HW``
whole frames, 4 row blocks of ``BF16_PARITY_SHARD_HW``) at windows 3, 5
and 11 (the tile, the energy kernel and the strip). The bf16 kernels copy
the aligned 4-byte word that holds each plane element, so a word past
either end of the plane stack would show here as an out-of-bounds read;
without PyTorch's caching allocator every tensor is its own allocation.
Prints one line per shape and the number of calls; needs one CUDA card.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    import chip_smoke as cs
    from videomorphing_tpu_torch.config import MorphParams
    from videomorphing_tpu_torch.kernels import sweep as ks
    from videomorphing_tpu_torch.kernels import warp as kw
    from videomorphing_tpu_torch.parallel.spatial import exchange_halo
    from videomorphing_tpu_torch.solver.energy import LevelData, make_level_data

    if not torch.cuda.is_available():
        print("memcheck_bf16_sweeps: no CUDA device is available", file=sys.stderr)
        return 1
    dev, BF16 = torch.device("cuda"), torch.bfloat16
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)
    calls = 0

    def inputs(h, w):
        rng = np.random.default_rng(h + w)
        i0 = t(rng.random((h, w, 3), dtype=np.float32))
        i1 = t(rng.random((h, w, 3), dtype=np.float32))
        vq = t(cs.smooth_field(h, w, 20.0, 1)).to(BF16).float()
        v = vq + t(cs.smooth_field(h, w, 0.5, 2))
        data = ks.pack_maps(make_level_data(
            i0, i1, t(rng.random((h, w, 1), dtype=np.float32)), v, t(rng.random((h, w, 1), dtype=np.float32)),
            v + 0.5), BF16)
        return i0, i1, vq, v, data

    for k in (3, 5, 11):
        p = MorphParams(ssim_window=k, ssim_sigma=cs.WINDOW_SIGMA[k])
        for h, w in ((135, 241),) + cs.BF16_PARITY_HW:
            i0, i1, vq, v, data = inputs(h, w)
            planes = kw.halfway_warp(i0, i1, vq, BF16)
            ks.sweep_grad(planes, vq, v, data, p)
            torch.cuda.synchronize()
            ks.sweep_energy(planes, vq, v, data, p)
            torch.cuda.synchronize()
            calls += 2
            print(f"{h}x{w} window {k}: kernels 1 and 2 (bf16)", flush=True)
        for h, w in cs.BF16_PARITY_SHARD_HW:
            i0, i1, vq, v, data = inputs(h, w)
            halo = exchange_halo(p)
            for _, row0, rows in cs._blocks(h, 4, halo):
                he = rows.stop - rows.start + 2 * halo
                vl_e, v_e = cs._ext(vq, row0, he), cs._ext(v, row0, he)
                data_k = LevelData(i0, i1, *(m[rows].contiguous() for m in (data.ui_w, data.ui_v, data.tc_w,
                                                                              data.tc_v)))
                pl_k = kw.halfway_warp_rows(i0, i1, vl_e, row0, BF16)
                ks.sweep_grad_shard(pl_k, vl_e, v_e, data_k, p, row0, h, halo)
                torch.cuda.synchronize()
                ks.sweep_energy_shard(pl_k, vl_e, v_e, data_k, p, row0, h, halo)
                torch.cuda.synchronize()
                calls += 2
            print(f"{h}x{w} / 4 window {k}: kernels 1s and 2s (bf16)", flush=True)
    print(f"memcheck_bf16_sweeps: {calls} calls of the bf16 forms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
