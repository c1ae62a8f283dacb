#!/usr/bin/env python3
"""What holds the bf16 forms of sweep kernels 1 and 2 back against their
float32 twins, on one CUDA card: knock-out variants.

    python3 scripts/time_torch_bf16_stages.py [--windows 5,11] [--shape 1024x1024]

Copies ``csrc/sweep.cu`` into ``build/bf16_stages/`` with two steps made
conditional on a ``KNOCK`` macro, builds one library per variant with the
port's nvcc flags (all at once), and times ``vm_sweep_grad`` and
``vm_sweep_energy`` in float32 and their ``_bf16`` entry points on
``chip_smoke.py`` phase 2's inputs (C = 3, v != v_lin, non-zero UI and TC
maps; bf16 planes and maps with v_lin rounded to bf16). A knocked-out
variant computes wrong values; only its device time
(``chip_smoke.graph_ms``, two readings) is printed, one JSON line per
window, kernel, form and variant, then the card's name and power limit.

Variants: 0 baseline; 1 no half select: a bf16 slot is read as the float
whose bits its 4-byte word holds (the same loads and copies, without the
select and byte permute per value); 2 no plane copies: neither form
issues the ``cp.async`` of its planes (the tile, the strip and the
energy kernel read whatever their slots hold), so the time left is the
rest of the kernel's work.
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
VARIANTS = {0: "baseline", 1: "no half select (bf16)", 2: "no plane copies"}
# (the code, the same code under a knock-out), in csrc/sweep.cu
EDITS = (
    ("  else return __uint_as_float(__byte_perm(",
     "  else if (KNOCK == 1) return slot;\n  else return __uint_as_float(__byte_perm("),
    ("          if constexpr (std::is_same_v<PT, float>) cp_async4(dst + k * NA + j,",
     "          if (KNOCK == 2) continue;\n          if constexpr (std::is_same_v<PT, float>) cp_async4(dst + k * NA + j,"),
    ("          if constexpr (std::is_same_v<PT, float>) cp_async16(sStage + k * NST + e,",
     "          if (KNOCK == 2) continue;\n          if constexpr (std::is_same_v<PT, float>) cp_async16(sStage + k * NST + e,"),
    ("            if constexpr (std::is_same_v<PT, float>) cp_async4(sStage + k * NST + e + m,",
     "            if (KNOCK == 2) continue;\n            if constexpr (std::is_same_v<PT, float>) cp_async4(sStage + k * NST + e + m,"),
    ("      if constexpr (std::is_same_v<PT, float>) cp_async4(s_pl + (slot * 6 + k) * 32 + lane,",
     "      if (KNOCK == 2) continue;\n      if constexpr (std::is_same_v<PT, float>) cp_async4(s_pl + (slot * 6 + k) * 32 + lane,"),
)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", default="5,11")
    ap.add_argument("--shape", default="1024x1024")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("time_torch_bf16_stages: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from videomorphing_tpu_torch.config import MorphParams
    from videomorphing_tpu_torch.kernels import build
    from videomorphing_tpu_torch.kernels import sweep as ks
    from videomorphing_tpu_torch.kernels import warp as kw
    from videomorphing_tpu_torch.solver.energy import make_level_data

    out_dir = ROOT / "build" / "bf16_stages"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC_DIR / "sweep.cu").read_text()
    for code, knocked in EDITS:
        if src.count(code) != 1:
            raise RuntimeError(f"csrc/sweep.cu no longer holds the staging as expected: {code!r}")
        src = src.replace(code, knocked)
    (out_dir / "sweep.cu").write_text("#ifndef KNOCK\n#define KNOCK 0\n#endif\n" + src)
    nvcc = build.find_nvcc()
    jobs = []
    for k in VARIANTS:
        lib = out_dir / f"libbf16stages{k}.so"
        cmd = [nvcc, *build.NVCC_FLAGS[:-2], "-shared", f"-DKNOCK={k}", "-I", str(build.CSRC_DIR),
               "-o", str(lib), str(out_dir / "sweep.cu")]
        jobs.append((k, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for k, path, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {k}:\n{log}")
        lib = ctypes.CDLL(str(path))
        for name in ("vm_sweep_grad", "vm_sweep_grad_bf16"):
            getattr(lib, name).argtypes = [P] * 10 + [I, P, L] + [P] * 3
            getattr(lib, name).restype = I
        for name in ("vm_sweep_energy", "vm_sweep_energy_bf16"):
            getattr(lib, name).argtypes = [P] * 8 + [I, P, L] + [P] * 3
            getattr(lib, name).restype = I
        libs[k] = lib

    dev = torch.device("cuda")
    BF16 = torch.bfloat16
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
    vq = v_lin.to(BF16).float()
    forms = {"float32": (kw.halfway_warp(i0, i1, v_lin), v_lin, data, ""),
             "bf16": (kw.halfway_warp(i0, i1, vq, BF16), vq, ks.pack_maps(data, BF16), "_bf16")}
    grad = torch.empty((h, w, 2), device=dev)
    precond = torch.empty((h, w, 2), device=dev)
    out = torch.empty(5, device=dev)
    for win in (int(k) for k in args.windows.split(",")):
        p = MorphParams(ssim_window=win, ssim_sigma=cs.WINDOW_SIGMA[win])
        r = ks.kernel_radius(p)
        s = ks._scalars(p, h, w, 3, taps=ks.window_taps(p, dev))
        for with_grad in (True, False):
            n = ks.n_partials(w, h, with_grad, r)
            parts = torch.empty((n, 4), device=dev)
            for form, (planes, vl, dt, sfx) in forms.items():
                maps = (dt.ui_w.data_ptr(), dt.ui_v.data_ptr(), dt.tc_w.data_ptr(), dt.tc_v.data_ptr())
                for k, lib in libs.items():
                    if k == 1 and form == "float32":
                        continue  # the float32 form has no half to select
                    if with_grad:
                        fn = getattr(lib, "vm_sweep_grad" + sfx)
                        extra = (grad.data_ptr(), precond.data_ptr())
                    else:
                        fn = getattr(lib, "vm_sweep_energy" + sfx)
                        extra = ()

                    def call(fn=fn, extra=extra, planes=planes, vl=vl, maps=maps):
                        err = fn(planes.data_ptr(), vl.data_ptr(), v.data_ptr(), *maps, *extra, parts.data_ptr(), n,
                                 None, 0, out.data_ptr(), ctypes.addressof(s), torch.cuda.current_stream().cuda_stream)
                        build.check(err, "sweep")
                    print(json.dumps({"shape": args.shape, "window": win, "kernel": ks.kernel_name(with_grad, r),
                                      "form": form, "variant": VARIANTS[k],
                                      "device_ms": [cs.graph_ms(call), cs.graph_ms(call)]}), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
