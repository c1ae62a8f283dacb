#!/usr/bin/env python3
"""Where kernel 1's strip (``sweep_grad_strip_kernel<R>``, windows 7-15)
spends its time, on one CUDA card: knock-out variants.

    python3 scripts/time_torch_strip_stages.py [--windows 7,11,15] [--shape 1024x1024]

Copies ``csrc/sweep.cu`` into ``build/strip_stages/`` with one stage of the
strip kernel's step made conditional on a ``KNOCK`` macro, builds one
library per variant with the port's nvcc flags (all at once), and times
``vm_sweep_grad`` of each on the same inputs as ``chip_smoke.py`` phase 2
(C = 3, v != v_lin, non-zero UI and TC maps). A variant that skips a stage
computes garbage; only its device time (``chip_smoke.graph_ms``, two
readings) is printed, one JSON line per window and variant, then the
card's name and power limit. The time a stage costs is the baseline's
less the variant's; the stages overlap, so the differences do not add up
to the whole.

Variants: 0 baseline; 1 no statistics' vertical sums (2a); 2 no
horizontal sums, SSIM and coefficient maps (2b); 3 no transposed vertical
sums (3a); 4 no transposed horizontal sums and chain (3b); 5 no last-channel
TPS stage (4); 6 no staging of the next step's planes; 7 no round trip
of the SSIM gradient and the curvature sums through grad / precond between
channels.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = {0: "baseline", 1: "no 2a (statistics, vertical)", 2: "no 2b (statistics, horizontal; SSIM maps)",
            3: "no 3a (transposed, vertical)", 4: "no 3b (transposed, horizontal; chain)",
            5: "no 4 (last channel: TPS)", 6: "no staging of the next step",
            7: "no grad / precond round trip between channels"}
# (the step's code, the same code under a knock-out), in csrc/sweep.cu's strip kernel
EDITS = (
    ("      if (s_lo < r_hi) {\n        constexpr int SEG = G::SEG_A",
     "      if (KNOCK != 1 && s_lo < r_hi) {\n        constexpr int SEG = G::SEG_A"),
    ("      if (s_lo < r_hi) {\n        for (int it = tid;", "      if (KNOCK != 2 && s_lo < r_hi) {\n        for (int it = tid;"),
    ("      if (o_lo < r_hi) {\n        constexpr int SEG = G::SEG_Q",
     "      if (KNOCK != 3 && o_lo < r_hi) {\n        constexpr int SEG = G::SEG_Q"),
    ("      if (mine) {\n        float tq[2][NQ];", "      if (KNOCK != 4 && mine) {\n        float tq[2][NQ];"),
    ("      if (!last) continue;", "      if (KNOCK == 5 || !last) continue;"),
    ("        if (!next_c || c + 1 < C) issue(", "        if (KNOCK != 6 && (!next_c || c + 1 < C)) issue("),
    ("          if (c > 0) {", "          if (KNOCK != 7 && c > 0) {"),
    ("          if (c + 1 < C) {", "          if (KNOCK != 7 && c + 1 < C) {"),
)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", default="7,11,15")
    ap.add_argument("--shape", default="1024x1024")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("time_torch_strip_stages: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from videomorphing_tpu_torch.config import MorphParams
    from videomorphing_tpu_torch.kernels import build
    from videomorphing_tpu_torch.kernels import sweep as ks
    from videomorphing_tpu_torch.kernels import warp as kw
    from videomorphing_tpu_torch.solver.energy import make_level_data

    out_dir = ROOT / "build" / "strip_stages"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC_DIR / "sweep.cu").read_text()
    for code, knocked in EDITS:
        if src.count(code) != 1:
            raise RuntimeError(f"csrc/sweep.cu no longer holds the strip kernel's step as expected: {code!r}")
        src = src.replace(code, knocked)
    (out_dir / "sweep.cu").write_text("#ifndef KNOCK\n#define KNOCK 0\n#endif\n" + src)
    nvcc = build.find_nvcc()
    jobs = []
    for k in VARIANTS:
        lib = out_dir / f"libstrip{k}.so"
        cmd = [nvcc, *build.NVCC_FLAGS[:-2], "-shared", f"-DKNOCK={k}", "-I", str(build.CSRC_DIR),
               "-o", str(lib), str(out_dir / "sweep.cu")]
        jobs.append((k, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for k, path, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {k}:\n{log}")
        lib = ctypes.CDLL(str(path))
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.vm_sweep_grad.argtypes = [P] * 10 + [I, P, L] + [P] * 3
        lib.vm_sweep_grad.restype = I
        libs[k] = lib

    dev = torch.device("cuda")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)
    h, w = (int(n) for n in args.shape.split("x"))
    rng = np.random.default_rng(h + w)
    i0 = t(rng.random((h, w, 3), dtype=np.float32))
    i1 = t(rng.random((h, w, 3), dtype=np.float32))
    v_lin = t(cs.smooth_field(h, w, 20.0, 1))
    v = t(cs.smooth_field(h, w, 20.0, 1) + cs.smooth_field(h, w, 0.5, 2))
    data = make_level_data(i0, i1, t(rng.random((h, w, 1), dtype=np.float32)),
                           v + t(0.1 * rng.standard_normal((h, w, 2)).astype(np.float32)),
                           t(rng.random((h, w, 1), dtype=np.float32)),
                           v + t(0.5 * rng.standard_normal((h, w, 2)).astype(np.float32)))
    planes = kw.halfway_warp(i0, i1, v_lin)
    for win in (int(k) for k in args.windows.split(",")):
        p = MorphParams(ssim_window=win, ssim_sigma=cs.WINDOW_SIGMA[win])
        r = ks.kernel_radius(p)
        if ks.kernel_name(True, r) != f"sweep_grad_strip_kernel<{r}>":
            raise ValueError(f"window {win} does not run the strip kernel")
        s = ks._scalars(p, h, w, 3, taps=ks.window_taps(p, dev))
        n = ks.n_partials(w, h, True, r)
        parts = torch.empty((n, 4), device=dev)
        out = torch.empty(5, device=dev)
        grad = torch.empty((h, w, 2), device=dev)
        precond = torch.empty((h, w, 2), device=dev)
        for k, lib in libs.items():
            def call(lib=lib):
                err = lib.vm_sweep_grad(planes.data_ptr(), v_lin.data_ptr(), v.data_ptr(), data.ui_w.data_ptr(),
                                        data.ui_v.data_ptr(), data.tc_w.data_ptr(), data.tc_v.data_ptr(),
                                        grad.data_ptr(), precond.data_ptr(), parts.data_ptr(), n, None, 0,
                                        out.data_ptr(), ctypes.addressof(s), torch.cuda.current_stream().cuda_stream)
                build.check(err, "vm_sweep_grad")
            print(json.dumps({"shape": args.shape, "window": win, "variant": VARIANTS[k],
                              "device_ms": [cs.graph_ms(call), cs.graph_ms(call)]}), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
