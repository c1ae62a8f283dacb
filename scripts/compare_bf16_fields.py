#!/usr/bin/env python3
"""How far ``pack_dtype="bfloat16"`` moves the pair field, in both packages.

    JAX_PLATFORMS=cpu python scripts/compare_bf16_fields.py [N]
    JAX_PLATFORMS=cpu python scripts/compare_bf16_fields.py --level

Solves frame 0 of the bench's N x N clip pair (default 128) with its 4
points through the reference's ``solver.ctf.optimize_pair`` (Pallas in
interpret mode, ``backend="pallas"``) and the port's (the plain versions,
``backend="pallas"``), at ``pack_dtype`` float32 and bfloat16 with
``pallas_min_pixels=0`` (every level takes the setting), and prints the
median, 99th percentile and maximum of |dv| between the four fields.
``--level`` does the same for one 60-iteration level solve of
``tests/test_torch_bf16_pack.py``'s 64 x 96 translation case (the
reference's ``TestBf16Pack`` case) through both packages'
``make_level_solver``. Runs on the CPU; needs jax and the JAX package
beside the port (the reference takes ~50 s a pair solve at N = 128).
"""

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv) -> int:
    import jax.numpy as jnp
    import torch

    from bench import _make_clips
    from videomorphing_tpu.config import MorphParams as JaxMorphParams
    from videomorphing_tpu.solver.ctf import optimize_pair as jax_optimize_pair
    from videomorphing_tpu_torch.config import MorphParams
    from videomorphing_tpu_torch.solver.ctf import optimize_pair

    torch.set_num_threads(4)
    level = "--level" in argv
    if level:
        from tests.test_torch_bf16_pack import _translation_case
        from videomorphing_tpu.solver.descent import make_level_solver as jax_level_solver
        from videomorphing_tpu.solver.energy import make_level_data as jax_level_data
        from videomorphing_tpu_torch.solver.descent import make_level_solver
        from videomorphing_tpu_torch.solver.energy import make_level_data

        i0, i1 = _translation_case()
        h, w = i0.shape[:2]
        what = f"{h}x{w} translation case, one 60-iteration level"

        def ref_solve(p):
            return jax_level_solver(p, 60)(jnp.zeros((h, w, 2), jnp.float32),
                                           jax_level_data(jnp.asarray(i0), jnp.asarray(i1)))[0]

        def port_solve(p):
            return make_level_solver(p, 60)(torch.zeros((h, w, 2)),
                                            make_level_data(torch.from_numpy(i0), torch.from_numpy(i1)))[0]
    else:
        n = int(argv[0]) if argv else 128
        clip_a, clip_b = _make_clips(1, n, n, seed=0)
        ys = np.linspace(n * 0.3, n * 0.7, 4)
        pts = np.stack([np.stack([ys, np.full(4, n * 0.45)], -1),
                        np.stack([ys, np.full(4, n * 0.55)], -1)], 1).astype(np.float32)
        what = f"{n}x{n} bench pair"

        def ref_solve(p):
            return jax_optimize_pair(jnp.asarray(clip_a[0]), jnp.asarray(clip_b[0]), jnp.asarray(pts), p).v

        def port_solve(p):
            return optimize_pair(torch.from_numpy(clip_a[0]), torch.from_numpy(clip_b[0]), torch.from_numpy(pts),
                                 p).v
    fields = {}
    for pd in ("float32", "bfloat16"):
        kw = dict(pack_dtype=pd, backend="pallas", pallas_min_pixels=0)
        t0 = time.perf_counter()
        fields["reference", pd] = np.asarray(ref_solve(JaxMorphParams(**kw)))
        t1 = time.perf_counter()
        fields["port", pd] = port_solve(MorphParams(**kw)).numpy()
        print(f"{pd}: reference {t1 - t0:.1f} s, port {time.perf_counter() - t1:.1f} s (CPU)", flush=True)

    def diff(a, b):
        d = np.abs(fields[a] - fields[b])
        return f"median {np.median(d):.3e} px, p99 {np.quantile(d, 0.99):.3e} px, max {d.max():.3e} px"

    print(f"{what}, |dv| between the fields:")
    for a, b in ((("reference", "bfloat16"), ("reference", "float32")), (("port", "bfloat16"), ("port", "float32")),
                 (("port", "float32"), ("reference", "float32")), (("port", "bfloat16"), ("reference", "bfloat16"))):
        print(f"  {a[0]} {a[1]} against {b[0]} {b[1]}: {diff(a, b)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
