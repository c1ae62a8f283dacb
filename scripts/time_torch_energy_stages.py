#!/usr/bin/env python3
"""Where sweep kernel 2 (the energy kernel) spends its time at windows
past 7, on one CUDA card: knock-out variants.

    python3 scripts/time_torch_energy_stages.py [--root DIR] [--windows 9,11,15] [--shape 1024x1024]

Copies ``videomorphing_tpu_torch/csrc/sweep.cu`` of ``DIR`` (default: this
checkout; an unpacked older commit is knocked out the same way) into
``build/energy_stages/<label>/`` with stages of its energy kernels made
conditional on a ``KNOCK`` macro, builds one library per variant with the
port's nvcc flags (all at once), and times ``vm_sweep_energy`` and
``vm_sweep_energy_bf16`` of each on the inputs of ``chip_smoke.py`` phase
2 (C = 3, v != v_lin, non-zero UI and TC maps; the bf16 form on bf16
planes and maps with v_lin rounded to bf16). ``DIR``'s
``kernels.sweep`` sizes the partials and names the kernel that runs at a
window. A knocked-out variant computes wrong values; only its device time
(``chip_smoke.graph_ms``, two readings) is printed, one JSON line per
window, form and variant, with the kernel's registers, local memory and
resident blocks per SM (``vm_sweep_kernel_info``), then the card's name
and power limit. A window whose energy runs another kernel (the wide
strip or the per-pixel chain) is timed as it is (variant 0 only). The time a stage costs is the baseline's less the
variant's; the stages overlap, so the differences do not add up.

Variants: 0 baseline; 1 no plane copies (no ``cp.async`` of the six
planes: the ring's slots hold whatever they held); 2 no horizontal
shuffles (each of the K products of a horizontal window sum takes the
lane's own vertical sum, so the multiply-adds stay); 3 no a0 / a1 on
the walk's halo rows (rows outside the warp's owned rows read no slot
and hold zeros; their copies still run); 4 no halo rows at all (3, and
their copies not issued either); 5 no TPS, UI and TC stage after the
channels; 6 no channel loop (what
is left is the kernel's fixed cost: dv, 1/n, the TPS, UI and TC stage,
the reductions and the launch).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
VARIANTS = {0: "baseline", 1: "no plane copies", 2: "no horizontal shuffles",
            3: "no a0/a1 on the halo rows", 4: "no halo rows (copies nor a0/a1)",
            5: "no TPS, UI and TC stage", 6: "no channel loop"}
# per energy kernel of csrc/sweep.cu: (its code, the same code under the
# knock-outs); every edit of the kernel that runs at a window must apply
EDITS = {
    "sweep_energy_kernel": (
        ("  auto issue = [&](int c, int u, int slot) {\n    const bool ok = (in & (1u << u)) != 0;",
         "  auto issue = [&](int c, int u, int slot) {\n    if (KNOCK == 4 && (u < R || u >= R + ESEG)) return;\n"
         "    const bool ok = (in & (1u << u)) != 0;"),
        ("      if constexpr (std::is_same_v<PT, float>) cp_async4(s_pl + (slot * 6 + k) * 32 + lane,",
         "      if (KNOCK == 1) continue;\n"
         "      if constexpr (std::is_same_v<PT, float>) cp_async4(s_pl + (slot * 6 + k) * 32 + lane,"),
        ("      const float a = slot_value<PT>(cur[0], half_sel(py ^ f0)) -",
         "      const bool halo_row = KNOCK >= 3 && (u < R || u >= R + ESEG);\n"
         "      const float a = halo_row ? 0.0f : slot_value<PT>(cur[0], half_sel(py ^ f0)) -"),
        ("      const float b = slot_value<PT>(cur[32], half_sel(py ^ f1)) +",
         "      const float b = halo_row ? 0.0f : slot_value<PT>(cur[32], half_sel(py ^ f1)) +"),
        ("acc += taps[t] * (t == R ? st[q] : __shfl_sync(FULL, st[q], lane - R + t));",
         "acc += taps[t] * (t == R || KNOCK == 2 ? st[q] : __shfl_sync(FULL, st[q], lane - R + t));"),
        ("  for (int u = 0; u < ESEG + 2; ++u) {\n    const int y = yw - 1 + u;",
         "  for (int u = 0; u < (KNOCK == 5 ? 0 : ESEG + 2); ++u) {\n    const int y = yw - 1 + u;"),
        ("  for (int c = 0; c < C; ++c) {\n    const int slot0 = c * NU;  // ring position",
         "  for (int c = 0; c < (KNOCK == 6 ? 0 : C); ++c) {\n    const int slot0 = c * NU;  // ring position"),
    ),
    "sweep_energy_strip_kernel": (
        ("  auto issue = [&](int c, int u, int slot) {\n    const bool ok = (in >> u) & 1u;",
         "  auto issue = [&](int c, int u, int slot) {\n    if (KNOCK == 4 && (u < R || u >= R + S)) return;\n"
         "    const bool ok = (in >> u) & 1u;"),
        ("      if constexpr (std::is_same_v<PT, float>) cp_async4(s_ring + (slot * 6 + k) * 32 + lane,",
         "      if (KNOCK == 1) continue;\n"
         "      if constexpr (std::is_same_v<PT, float>) cp_async4(s_ring + (slot * 6 + k) * 32 + lane,"),
        ("      a = slot_value<PT>(cur[0], half_sel(py ^ f0)) -",
         "      const bool halo_row = KNOCK >= 3 && (u < R || u >= R + S);\n"
         "      a = halo_row ? 0.0f : slot_value<PT>(cur[0], half_sel(py ^ f0)) -"),
        ("      b = slot_value<PT>(cur[32], half_sel(py ^ f1)) +",
         "      b = halo_row ? 0.0f : slot_value<PT>(cur[32], half_sel(py ^ f1)) +"),
        ("acc += tap(t) * (t == R ? st[q] : __shfl_sync(FULL, st[q], lane - R + t));",
         "acc += tap(t) * (t == R || KNOCK == 2 ? st[q] : __shfl_sync(FULL, st[q], lane - R + t));"),
        ("  for (int u0 = 0; u0 < S + 2; u0 += EG) {",
         "  for (int u0 = 0; u0 < (KNOCK == 5 ? 0 : S + 2); u0 += EG) {"),
        ("  for (int c = 0; c < C; ++c) {\n    const int slot0 = c * NU;  // the ring step",
         "  for (int c = 0; c < (KNOCK == 6 ? 0 : C); ++c) {\n    const int slot0 = c * NU;  // the ring step"),
    ),
}


def knocked_source(src: str) -> str:
    """``src`` with every energy kernel's stages under ``KNOCK``; raises if a
    kernel that the source defines no longer holds an edit's code."""
    for kernel, edits in EDITS.items():
        if f"\n{kernel}(" not in src:
            continue
        for code, knocked in edits:
            if src.count(code) != 1:
                raise RuntimeError(f"csrc/sweep.cu no longer holds {kernel}'s code as expected: {code!r}")
            src = src.replace(code, knocked)
    return "#ifndef KNOCK\n#define KNOCK 0\n#endif\n" + src


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE), help="checkout whose csrc/sweep.cu is knocked out")
    ap.add_argument("--label", default=None)
    ap.add_argument("--windows", default="9,11,15")
    ap.add_argument("--shape", default="1024x1024")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import importlib.util

    import torch

    # this checkout's helpers, whichever checkout's kernel is knocked out
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        print("time_torch_energy_stages: no CUDA device is available", file=sys.stderr)
        return 1
    from videomorphing_tpu_torch.config import MorphParams
    from videomorphing_tpu_torch.kernels import build
    from videomorphing_tpu_torch.kernels import sweep as ks
    from videomorphing_tpu_torch.kernels import warp as kw
    from videomorphing_tpu_torch.solver.energy import make_level_data

    if build.PACKAGE_DIR.parent != root:
        raise RuntimeError(f"imported the port from {build.PACKAGE_DIR.parent}, not {root}")
    label = args.label or str(root)
    out_dir = HERE / "build" / "energy_stages" / (os.path.basename(str(root)) or "root")
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "sweep.cu").write_text(knocked_source((build.CSRC_DIR / "sweep.cu").read_text()))
    nvcc = build.find_nvcc()
    jobs = []
    for k in VARIANTS:
        lib = out_dir / f"libenergy{k}.so"
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
        for name in ("vm_sweep_energy", "vm_sweep_energy_bf16"):
            getattr(lib, name).argtypes = [P] * 8 + [I, P, L] + [P] * 3
            getattr(lib, name).restype = I
        lib.vm_sweep_n_partials.argtypes = [I, I, I, I]
        lib.vm_sweep_kernel_info.argtypes = [I, I, I, P]
        lib.vm_sweep_scratch_floats.argtypes = [I, I, I, I]
        lib.vm_sweep_scratch_floats.restype = L
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
    out = torch.empty(5, device=dev)
    info = (ctypes.c_int * 6)()
    for win in (int(k) for k in args.windows.split(",")):
        p = MorphParams(ssim_window=win, ssim_sigma=cs.WINDOW_SIGMA[win])
        r = ks.kernel_radius(p)
        kernel = ks.kernel_name(False, r)
        s = ks._scalars(p, h, w, 3, taps=ks.window_taps(p, dev))
        n = libs[0].vm_sweep_n_partials(w, h, 0, r)
        parts = torch.empty((n, 4), device=dev)
        n_scratch = libs[0].vm_sweep_scratch_floats(w, h, 0, r)
        scratch = torch.empty(max(n_scratch, 1), device=dev)
        variants = list(VARIANTS) if kernel.startswith(tuple(EDITS)) else [0]
        for form, (planes, vl, dt, sfx) in forms.items():
            build.check(libs[0].vm_sweep_kernel_info(r, 0, int(bool(sfx)), info), "vm_sweep_kernel_info")
            maps = (dt.ui_w.data_ptr(), dt.ui_v.data_ptr(), dt.tc_w.data_ptr(), dt.tc_v.data_ptr())
            for k in variants:
                fn = getattr(libs[k], "vm_sweep_energy" + sfx)

                def call(fn=fn, planes=planes, vl=vl, maps=maps):
                    err = fn(planes.data_ptr(), vl.data_ptr(), v.data_ptr(), *maps, parts.data_ptr(), n,
                             scratch.data_ptr(), n_scratch, out.data_ptr(), ctypes.addressof(s),
                             torch.cuda.current_stream().cuda_stream)
                    build.check(err, "vm_sweep_energy" + sfx)
                print(json.dumps({"label": label, "shape": args.shape, "window": win, "kernel": kernel,
                                  "form": form, "variant": VARIANTS[k],
                                  "device_ms": [cs.graph_ms(call), cs.graph_ms(call)],
                                  "registers": info[0], "local_bytes": info[3], "blocks_per_sm": info[4],
                                  "threads_per_block": info[5] or 256}),
                      flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
