#!/usr/bin/env python3
"""Where sweep kernels 1 and 2 spend their time on the wide path (SSIM
windows 1 and 17 up), on one CUDA card: knock-out and design variants.

    python3 scripts/time_torch_wide_stages.py [--root DIR] [--windows 1,17] [--shape 1024x1024]

Copies ``videomorphing_tpu_torch/csrc/sweep.cu`` of ``DIR`` (default: this
checkout; an unpacked older commit is knocked out the same way) into
``build/wide_stages/<label>/`` with stages of the kernels that serve the
wide windows made conditional on a ``KNOCK`` macro, builds one library per
variant with the port's nvcc flags (all at once), and times
``vm_sweep_grad``, ``vm_sweep_energy`` and their bf16 twins of each on the
inputs of ``chip_smoke.py`` phase 2 (C = 3, v != v_lin, non-zero UI and TC
maps; the bf16 form on bf16 planes and maps with v_lin rounded to bf16).
``DIR``'s ``kernels.sweep`` sizes the partials and the scratch buffer and
names the kernel that runs at a window. A knocked-out variant computes
wrong values; only its device time (``chip_smoke.graph_ms``, two readings)
is printed, one JSON line per window, kernel, form and variant, then the
card's name and power limit. The time a stage costs is the baseline's less
the variant's; the stages overlap, so the differences do not add up.

Two designs are knocked out, each where its kernels run:

- the per-pixel chain (``wide_*_kernel``, a scratch buffer in device
  memory): 1 no bounds test on the taps of a horizontal window sum (the
  row is read past its ends, inside the scratch buffer); 2 the scratch
  buffer's regions laid over one another, so the intermediates' round
  trips stay in L2; 3 launches only (every kernel of the chain returns at
  once); 4 no TPS maps at the neighbours (the gradient's adjoint stencil);
- the fused strip (``sweep_wide_kernel``, R at run time): 11 no plane
  copies (no ``cp.async`` of the step's planes, v and v_lin); 12 no
  window sums of the statistics (vertical and horizontal); 13 no
  transposed window sums (the gradient's); 14 no TPS, UI and TC stage;
  15 no channel loop (what is left: the taps, 1/n, the reductions and
  the launch); 16 no SSIM, coefficient maps or curvature terms (nor the
  gradient's dw loads for them): the statistics' window sums are summed
  and dropped. And other designs of it, which compute the same values
  (``DESIGNS``: a source edited as each says): 21 the gradient's strips
  64 rows tall; 22 the energy's 128; 23 the gradient capped at 80
  registers for three blocks an SM; 24 64-column strips walked 4 rows a
  step (reach 22); 25 4 outputs an item in the window passes; 26 the
  vertical passes chunked, four taps from one broadcast ``float4`` and
  each loaded row shared by four output rows.

A window whose kernel is neither is timed as it is (variant 0 only).
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
CHAIN = {0: "baseline", 1: "no bounds tests on the horizontal taps", 2: "scratch regions overlaid (in L2)",
         3: "launches only", 4: "no TPS maps at the neighbours"}
STRIP = {0: "baseline", 11: "no plane copies", 12: "no statistics window sums", 13: "no transposed window sums",
         14: "no TPS, UI and TC stage", 15: "no channel loop", 16: "no SSIM, coefficient maps or curvature",
         21: "gradient strips of 64 rows", 22: "energy strips of 128 rows", 23: "gradient at 80 registers",
         24: "64 columns, 4-row steps", 25: "4 outputs an item", 26: "chunked vertical passes"}
VARIANTS = {**CHAIN, **STRIP}
# (marker of the design in csrc/sweep.cu, its code, the same code under the
# knock-outs); every edit of a design that the source holds must apply
EDITS = {
    "chain": ("\nwide_final_kernel(", (
        ("    acc += __ldg(taps + t) * (q >= 0 && q < w ? row[q] : 0.0f);",
         "    acc += __ldg(taps + t) * (KNOCK == 1 || (q >= 0 && q < w) ? row[q] : 0.0f);"),
        ("  float* const V = a.scratch + L.v;", "  float* const V = a.scratch + (KNOCK == 2 ? 0 : L.v);"),
        ("  float* const es = a.scratch + L.es;", "  float* const es = a.scratch + (KNOCK == 2 ? 0 : L.es);"),
        ("  float* const Q = a.scratch + L.q;", "  float* const Q = a.scratch + (KNOCK == 2 ? 0 : L.q);"),
        ("  float* const curv = a.scratch + L.curv;", "  float* const curv = a.scratch + (KNOCK == 2 ? 0 : L.curv);"),
        ("  float* const gs = a.scratch + L.gs;", "  float* const gs = a.scratch + (KNOCK == 2 ? 0 : L.gs);"),
        ("const float* __restrict__ v, float* __restrict__ A, int c, VmSweepScalars s) {",
         "const float* __restrict__ v, float* __restrict__ A, int c, VmSweepScalars s) {\n  if (KNOCK == 3) return;"),
        ("wide_stats_vertical_kernel(const float* __restrict__ A, float* __restrict__ V, VmSweepScalars s) {",
         "wide_stats_vertical_kernel(const float* __restrict__ A, float* __restrict__ V, VmSweepScalars s) {\n"
         "  if (KNOCK == 3) return;"),
        ("float* __restrict__ curv, float* __restrict__ es, int c, VmSweepScalars s) {",
         "float* __restrict__ curv, float* __restrict__ es, int c, VmSweepScalars s) {\n  if (KNOCK == 3) return;"),
        ("wide_vertical_kernel(const float* __restrict__ in, float* __restrict__ out, int nq, VmSweepScalars s) {",
         "wide_vertical_kernel(const float* __restrict__ in, float* __restrict__ out, int nq, VmSweepScalars s) {\n"
         "  if (KNOCK == 3) return;"),
        ("const float* __restrict__ VQ, float* __restrict__ gs, int c, VmSweepScalars s) {",
         "const float* __restrict__ VQ, float* __restrict__ gs, int c, VmSweepScalars s) {\n  if (KNOCK == 3) return;"),
        ("                  float* __restrict__ partials, VmSweepScalars s) {\n  const int R = s.radius, w = s.w, h = s.h",
         "                  float* __restrict__ partials, VmSweepScalars s) {\n  if (KNOCK == 3) return;\n"
         "  const int R = s.radius, w = s.w, h = s.h"),
        ("        // self-adjoint stencils of the three maps (descent.py tps_adj_*)\n        float l_xx",
         "        if (KNOCK == 4) { gk[k] = vxx; continue; }\n"
         "        // self-adjoint stencils of the three maps (descent.py tps_adj_*)\n        float l_xx"),
    )),
    "strip": ("\nsweep_wide_kernel(", (
        ("    for (int ch = tid; ch < G.NCH; ch += NT) {\n      const int ch_row",
         "    for (int ch = tid; ch < (KNOCK == 11 ? 0 : G.NCH); ch += NT) {\n      const int ch_row"),
        ("          for (int uu = 0; uu < P + 2 * R; ++uu, slot = slot + 1 == DR ? 0 : slot + 1) {\n"
         "            const float a = sA[",
         "          for (int uu = 0; uu < (KNOCK == 12 ? 0 : P + 2 * R); ++uu, slot = slot + 1 == DR ? 0 : slot + 1) {\n"
         "            const float a = sA["),
        ("          for (int u = 0; u < P + 2 * R; ++u) {\n            float xv[5];",
         "          for (int u = 0; u < (KNOCK == 12 ? 0 : P + 2 * R); ++u) {\n            float xv[5];"),
        ("            for (int uu = 0; uu < P + 2 * R; ++uu, slot = slot + 1 == DR ? 0 : slot + 1) {\n"
         "              float xq[6];",
         "            for (int uu = 0; uu < (KNOCK == 13 ? 0 : P + 2 * R); ++uu, slot = slot + 1 == DR ? 0 : slot + 1) {\n"
         "              float xq[6];"),
        ("          for (int t = 0; t < K; ++t) {\n            const float tp = sTap[t];",
         "          for (int t = 0; t < (KNOCK == 13 ? 0 : K); ++t) {\n            const float tp = sTap[t];"),
        ("            for (int qq = 0; qq < 6; ++qq) out[qq][j] = 0.0f;\n"
         "            if (row_ok && js < SW && x >= 0 && x < w) {",
         "            for (int qq = 0; qq < 6; ++qq) out[qq][j] = 0.0f;\n"
         "            if (KNOCK != 16 && row_ok && js < SW && x >= 0 && x < w) {"),
        ("      if (!last) continue;\n\n      // 4. last channel: the TPS maps of the output rows (with the gradient",
         "      if (!last || KNOCK == 14) continue;\n\n"
         "      // 4. last channel: the TPS maps of the output rows (with the gradient"),
        ("  for (int c = 0; c < C; ++c) {\n    for (int i = 0; i < nstep; ++i) {\n"
         "      const int u0 = i * RB;  // walk row of the step's first staged row\n"
         "      // the step's statistics rows are walk rows u0 - R + r and its output\n      // rows u0 - HA + r",
         "  for (int c = 0; c < (KNOCK == 15 ? 0 : C); ++c) {\n    for (int i = 0; i < nstep; ++i) {\n"
         "      const int u0 = i * RB;  // walk row of the step's first staged row\n"
         "      // the step's statistics rows are walk rows u0 - R + r and its output\n      // rows u0 - HA + r"),
    )),
}


# the vertical passes (2a, 3a) as the source has them, and chunked by four taps
_VERTICAL_2A = '''        for (int it = tid; it < (RB / P) * AWP; it += NT) {
          const int r0 = (it / AWP) * P, j = it % AWP;
          if (r0 + P <= s_lo || r0 >= r_hi) continue;
          float acc[P][5];
#pragma unroll
          for (int jj = 0; jj < P; ++jj)
#pragma unroll
            for (int q = 0; q < 5; ++q) acc[jj][q] = 0.0f;
          int slot = (u0 - 2 * R + r0 + 2 * DR) % DR;  // ring row of walk row u0 - 2R + r0
          for (int uu = 0; uu < P + 2 * R; ++uu, slot = slot + 1 == DR ? 0 : slot + 1) {
            const float a = sA[slot * AWP + j], b = sA[(DR + slot) * AWP + j];
            const float aa = a * a, bb = b * b, ab = a * b;
#pragma unroll
            for (int jj = 0; jj < P; ++jj) {
              const float tp = sTap[uu - jj];
              acc[jj][0] += tp * a;
              acc[jj][1] += tp * b;
              acc[jj][2] += tp * aa;
              acc[jj][3] += tp * bb;
              acc[jj][4] += tp * ab;
            }
          }
#pragma unroll
          for (int jj = 0; jj < P; ++jj)
#pragma unroll
            for (int q = 0; q < 5; ++q) sX[(q * RB + r0 + jj) * AWP + j] = acc[jj][q];
        }'''
_CHUNKED_2A = '''        constexpr int VP = 4;
        for (int it = tid; it < (RB / VP) * AWP; it += NT) {
          const int r0 = (it / AWP) * VP, j = it % AWP;
          if (r0 + VP <= s_lo || r0 >= r_hi) continue;
          float acc[VP][5];
#pragma unroll
          for (int jj = 0; jj < VP; ++jj)
#pragma unroll
            for (int q = 0; q < 5; ++q) acc[jj][q] = 0.0f;
          int slot = (u0 - 2 * R + r0 + 2 * DR) % DR;
          for (int t0 = 0; t0 < K; t0 += 4, slot = slot + 4 >= DR ? slot + 4 - DR : slot + 4) {
            const float4 tp = *reinterpret_cast<const float4*>(sTap + t0);
            float x[VP + 3][5];
#pragma unroll
            for (int i = 0, sl = slot; i < VP + 3; ++i, sl = sl + 1 == DR ? 0 : sl + 1) {
              const float a = sA[sl * AWP + j], b = sA[(DR + sl) * AWP + j];
              x[i][0] = a;
              x[i][1] = b;
              x[i][2] = a * a;
              x[i][3] = b * b;
              x[i][4] = a * b;
            }
#pragma unroll
            for (int jj = 0; jj < VP; ++jj)
#pragma unroll
              for (int q = 0; q < 5; ++q) {
                acc[jj][q] += tp.x * x[jj][q];
                acc[jj][q] += tp.y * x[jj + 1][q];
                acc[jj][q] += tp.z * x[jj + 2][q];
                acc[jj][q] += tp.w * x[jj + 3][q];
              }
          }
#pragma unroll
          for (int jj = 0; jj < VP; ++jj)
#pragma unroll
            for (int q = 0; q < 5; ++q) sX[(q * RB + r0 + jj) * AWP + j] = acc[jj][q];
        }'''
_VERTICAL_3A = '''          for (int it = tid; it < (RB / P) * SWP; it += NT) {
            const int r0 = (it / SWP) * P, j = it % SWP;
            if (r0 + P <= o_lo || r0 >= r_hi) continue;
            float acc[P][6];
#pragma unroll
            for (int jj = 0; jj < P; ++jj)
#pragma unroll
              for (int qq = 0; qq < 6; ++qq) acc[jj][qq] = 0.0f;
            int slot = (u0 - 3 * R + r0 + 2 * DR) % DR;  // ring row of walk row u0 - 3R + r0
            for (int uu = 0; uu < P + 2 * R; ++uu, slot = slot + 1 == DR ? 0 : slot + 1) {
              float xq[6];
#pragma unroll
              for (int qq = 0; qq < 6; ++qq) xq[qq] = sQ[(qq * DR + slot) * SWP + j];
#pragma unroll
              for (int jj = 0; jj < P; ++jj) {
                const float tp = sTap[uu - jj];
#pragma unroll
                for (int qq = 0; qq < 6; ++qq) acc[jj][qq] += tp * xq[qq];
              }
            }
#pragma unroll
            for (int jj = 0; jj < P; ++jj)
#pragma unroll
              for (int qq = 0; qq < 6; ++qq) sX[(qq * RB + r0 + jj) * SWP + j] = acc[jj][qq];
          }'''
_CHUNKED_3A = '''          constexpr int VP = 4;
          for (int it = tid; it < (RB / VP) * SWP; it += NT) {
            const int r0 = (it / SWP) * VP, j = it % SWP;
            if (r0 + VP <= o_lo || r0 >= r_hi) continue;
            float acc[VP][6];
#pragma unroll
            for (int jj = 0; jj < VP; ++jj)
#pragma unroll
              for (int qq = 0; qq < 6; ++qq) acc[jj][qq] = 0.0f;
            int slot = (u0 - 3 * R + r0 + 2 * DR) % DR;
            for (int t0 = 0; t0 < K; t0 += 4, slot = slot + 4 >= DR ? slot + 4 - DR : slot + 4) {
              const float4 tp = *reinterpret_cast<const float4*>(sTap + t0);
              float x[VP + 3][6];
#pragma unroll
              for (int i = 0, sl = slot; i < VP + 3; ++i, sl = sl + 1 == DR ? 0 : sl + 1)
#pragma unroll
                for (int qq = 0; qq < 6; ++qq) x[i][qq] = sQ[(qq * DR + sl) * SWP + j];
#pragma unroll
              for (int jj = 0; jj < VP; ++jj)
#pragma unroll
                for (int qq = 0; qq < 6; ++qq) {
                  acc[jj][qq] += tp.x * x[jj][qq];
                  acc[jj][qq] += tp.y * x[jj + 1][qq];
                  acc[jj][qq] += tp.z * x[jj + 2][qq];
                  acc[jj][qq] += tp.w * x[jj + 3][qq];
                }
            }
#pragma unroll
            for (int jj = 0; jj < VP; ++jj)
#pragma unroll
              for (int qq = 0; qq < 6; ++qq) sX[(qq * RB + r0 + jj) * SWP + j] = acc[jj][qq];
          }'''
# the strip's other designs: (code, the same code in the design) each
DESIGNS = {
    21: (("constexpr int WIDE_STRIP_ROWS = 128;", "constexpr int WIDE_STRIP_ROWS = 64;"),),
    22: (("constexpr int WIDE_ENERGY_STRIP_ROWS = 64;", "constexpr int WIDE_ENERGY_STRIP_ROWS = 128;"),),
    23: (("__launch_bounds__(NT, WITH_GRAD ? 2 : 4)\nsweep_wide_kernel(",
          "__launch_bounds__(NT, WITH_GRAD ? 3 : 4)\nsweep_wide_kernel("),),
    24: (("constexpr int WIDE_STRIP_COLS = 32;\nconstexpr int WIDE_STEP_ROWS = 8;\nconstexpr int WIDE_MAX_RADIUS = 24;",
          "constexpr int WIDE_STRIP_COLS = 64;\nconstexpr int WIDE_STEP_ROWS = 4;\nconstexpr int WIDE_MAX_RADIUS = 22;"),),
    25: (("RB = WIDE_STEP_ROWS, P = 2;", "RB = WIDE_STEP_ROWS, P = 4;"),),
    26: ((_VERTICAL_2A, _CHUNKED_2A), (_VERTICAL_3A, _CHUNKED_3A)),
}


def design_source(src: str, k: int) -> str:
    """``src`` as design variant ``k`` has it; raises if an edit no longer
    applies."""
    for code, new in DESIGNS[k]:
        if src.count(code) != 1:
            raise RuntimeError(f"csrc/sweep.cu no longer holds the code design {k} replaces: {code[:80]!r}")
        src = src.replace(code, new)
    return src


def knocked_source(src: str) -> str:
    """``src`` with the stages of every design it holds under ``KNOCK``;
    raises if a design that the source holds no longer has an edit's code."""
    for design, (marker, edits) in EDITS.items():
        if marker not in src:
            continue
        for code, knocked in edits:
            if src.count(code) != 1:
                raise RuntimeError(f"csrc/sweep.cu no longer holds the {design}'s code as expected: {code!r}")
            src = src.replace(code, knocked)
    return "#ifndef KNOCK\n#define KNOCK 0\n#endif\n" + src


def design_of(kernel: str) -> str | None:
    """The design of the kernel ``kernels.sweep.kernel_name`` names."""
    if kernel.startswith("wide path") or "chain" in kernel:
        return "chain"
    if kernel.startswith("sweep_wide_kernel"):
        return "strip"
    return None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE), help="checkout whose csrc/sweep.cu is knocked out")
    ap.add_argument("--label", default=None)
    ap.add_argument("--windows", default="1,17")
    ap.add_argument("--shape", default="1024x1024")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import importlib.util

    import torch

    # this checkout's helpers, whichever checkout's kernels are knocked out
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        print("time_torch_wide_stages: no CUDA device is available", file=sys.stderr)
        return 1
    from videomorphing_tpu_torch.config import MorphParams
    from videomorphing_tpu_torch.kernels import build
    from videomorphing_tpu_torch.kernels import sweep as ks
    from videomorphing_tpu_torch.kernels import warp as kw
    from videomorphing_tpu_torch.solver.energy import make_level_data

    if build.PACKAGE_DIR.parent != root:
        raise RuntimeError(f"imported the port from {build.PACKAGE_DIR.parent}, not {root}")
    label = args.label or str(root)
    raw = (build.CSRC_DIR / "sweep.cu").read_text()
    src = knocked_source(raw)
    held = [d for d, (marker, _) in EDITS.items() if marker in src]
    variants = [0] + [k for d in held for k in (CHAIN if d == "chain" else STRIP) if k]
    out_dir = HERE / "build" / "wide_stages" / (os.path.basename(str(root)) or "root")
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    jobs = []
    for k in variants:
        lib, cu = out_dir / f"libwide{k}.so", out_dir / f"sweep{k}.cu"
        cu.write_text(design_source(raw, k) if k in DESIGNS else src)
        cmd = [nvcc, *build.NVCC_FLAGS[:-2], "-shared", f"-DKNOCK={k}", "-I", str(build.CSRC_DIR),
               "-o", str(lib), str(cu)]
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
        for name in ("vm_sweep_energy", "vm_sweep_energy_bf16"):
            getattr(lib, name).argtypes = [P] * 8 + [I, P, L] + [P] * 3
        lib.vm_sweep_n_partials.argtypes = [I, I, I, I]
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
    grad = torch.empty((h, w, 2), device=dev)
    precond = torch.empty((h, w, 2), device=dev)
    for win in (int(k) for k in args.windows.split(",")):
        p = MorphParams(ssim_window=win, ssim_sigma=cs.WINDOW_SIGMA.get(win, 3.0))
        r = ks.kernel_radius(p)
        s = ks._scalars(p, h, w, 3, taps=ks.window_taps(p, dev))
        for with_grad in (True, False):
            kernel = ks.kernel_name(with_grad, r)
            design = design_of(kernel)
            # the most partials and scratch any variant's geometry asks for
            n = max(lib.vm_sweep_n_partials(w, h, int(with_grad), r) for lib in libs.values())
            parts = torch.empty((n, 4), device=dev)
            n_scratch = max(lib.vm_sweep_scratch_floats(w, h, int(with_grad), r) for lib in libs.values())
            scratch = torch.empty(max(n_scratch, 1), device=dev)
            mine = [0] + [k for k in variants if k and k in (CHAIN if design == "chain" else STRIP if design else ())]
            for form, (planes, vl, dt, sfx) in forms.items():
                maps = (dt.ui_w.data_ptr(), dt.ui_v.data_ptr(), dt.tc_w.data_ptr(), dt.tc_v.data_ptr())
                name = ("vm_sweep_grad" if with_grad else "vm_sweep_energy") + sfx
                for k in mine:
                    fn = getattr(libs[k], name)
                    outs = (grad.data_ptr(), precond.data_ptr()) if with_grad else ()

                    def call(fn=fn, planes=planes, vl=vl, maps=maps, outs=outs):
                        err = fn(planes.data_ptr(), vl.data_ptr(), v.data_ptr(), *maps, *outs, parts.data_ptr(), n,
                                 scratch.data_ptr(), n_scratch, out.data_ptr(), ctypes.addressof(s),
                                 torch.cuda.current_stream().cuda_stream)
                        build.check(err, name)
                    print(json.dumps({"label": label, "shape": args.shape, "window": win, "kernel": kernel,
                                      "form": form, "variant": VARIANTS[k],
                                      "device_ms": [cs.graph_ms(call), cs.graph_ms(call)]}), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
