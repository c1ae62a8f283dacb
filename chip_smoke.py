#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``videomorphing_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --kernels  # phases 0-2 only; prints no result line

Phases:
  0. the card: ``require_cuda()`` and its name and power limit from nvidia-smi;
  1. build the CUDA kernels of ``videomorphing_tpu_torch/csrc`` with nvcc;
  2. each kernel against its plain PyTorch version on the card, at the
     slice's shapes (1024 x 1024 and a ragged 135 x 241, C = 3; the sampler
     also at C = 4 on the stacked [disp, v] planes), with the median time of
     kernel and plain version (CUDA events);
  3. the main path: ``api.morph_pair`` on a 1024 x 1024 pair with 4 point
     constraints and 16 frames, with every kernel's launch count;
  4. the golden translation at 256 x 256: the midpoint frame against its
     analytic truth (SSIM >= 0.99).

Any failure raises and exits non-zero. The second-to-last line is one JSON
object with a record per kernel; the last line is
``{"ok": true, "device": {...}}``. With no CUDA device it exits 1 and prints
no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

KERNELS = {
    "halfway_warp": ("videomorphing_tpu_torch/csrc/warp.cu", "videomorphing_tpu/pallas/warp.py:206"),
    "bilinear_sample": ("videomorphing_tpu_torch/csrc/warp.cu", "videomorphing_tpu/pallas/warp.py:311"),
    "sweep_grad": ("videomorphing_tpu_torch/csrc/sweep.cu", "videomorphing_tpu/pallas/sweep.py:293"),
    "sweep_energy": ("videomorphing_tpu_torch/csrc/sweep.cu", "videomorphing_tpu/pallas/sweep.py:502"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok, msg: str) -> None:
    """A failed check ends the run with a non-zero exit."""
    if not ok:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn()`` in ms (CUDA events around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def smooth_field(h: int, w: int, amp: float, seed: int) -> np.ndarray:
    """A smooth (H, W, 2) field of up to ~``amp`` px plus a shift that moves
    content off the frame near the borders."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    f = np.zeros((h, w, 2))
    for k in range(2):
        for _ in range(3):
            fy, fx, ph = rng.uniform(0.5, 3.0), rng.uniform(0.5, 3.0), rng.uniform(0, 2 * np.pi)
            f[..., k] += np.sin(2 * np.pi * (fy * yy / h + fx * xx / w) + ph)
    f *= amp / (np.abs(f).max() + 1e-12)
    f[..., 1] += 0.25 * amp
    return f.astype(np.float32)


def check_kernels(dev) -> dict:
    """Phase 2: every kernel against its plain version on the card."""
    import torch

    from videomorphing_tpu_torch.config import MorphParams
    from videomorphing_tpu_torch.kernels import sweep as ks
    from videomorphing_tpu_torch.kernels import warp as kw
    from videomorphing_tpu_torch.ops.resample import grid_coords
    from videomorphing_tpu_torch.solver.energy import make_level_data

    p = MorphParams()
    rec = {name: {"max_abs_err": 0.0, "max_rel_err": 0.0} for name in KERNELS}
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    def compare(name, ref, got, shape, tol, rel_to_max):
        ref = ref.double()
        got = got.double()
        err = float((ref - got).abs().max())
        scale = float(ref.abs().max())
        rel = err / (scale + 1e-30)
        limit = tol * scale if rel_to_max else tol
        log(f"  {name} {shape}: max_abs_err={err:.3e} rel={rel:.3e} (limit {limit:.3e})")
        require(torch.isfinite(got).all(), f"{name}: non-finite output")
        require(err <= limit, f"{name} {shape}: max abs err {err} > {limit}")
        r = rec[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["max_rel_err"] = max(r["max_rel_err"], rel)

    for h, w in ((1024, 1024), (135, 241)):
        full = (h, w) == (1024, 1024)
        rng = np.random.default_rng(h + w)
        i0 = t(rng.random((h, w, 3), dtype=np.float32))
        i1 = t(rng.random((h, w, 3), dtype=np.float32))
        v_lin = t(smooth_field(h, w, 20.0, 1))
        v = t(smooth_field(h, w, 20.0, 1) + smooth_field(h, w, 0.5, 2))
        shape = f"{h}x{w}"

        # kernel 3: tolerance 1e-6 abs (values in [0, 1]; the kernel rounds
        # each lerp step as the plain version's separate operations do)
        planes = kw.halfway_warp(i0, i1, v_lin)
        compare("halfway_warp", kw.halfway_warp_plain(i0, i1, v_lin), planes, shape, 1e-6, False)

        # kernel 4 at C = 4 (stacked [disp, v], coordinates ~ the path
        # inversion's) and C = 3 (colour samples); tolerance 1e-6 of max|ref|
        # (the stacked planes hold pixel displacements)
        g = grid_coords(h, w, device=dev)
        stacked = torch.cat([v_lin * -0.5, v_lin], -1).contiguous()
        p_co = (g + 0.5 * v_lin).contiguous()
        compare("bilinear_sample", kw.bilinear_sample_plain(stacked, p_co),
                kw.bilinear_sample(stacked, p_co), shape + "x4", 1e-6, True)
        phi = (g - v).contiguous()
        compare("bilinear_sample", kw.bilinear_sample_plain(i0, phi),
                kw.bilinear_sample(i0, phi), shape + "x3", 1e-6, True)

        # kernels 1-2 on v != v_lin with non-zero UI and TC maps: energy rel
        # <= 1e-5, grad and precond max abs <= 1e-5 * max|ref| (float32 with
        # other summation orders and contracted multiply-adds)
        # constraint targets near v, so the four energy terms are of one
        # order and the energy comparison sees the SSIM term too
        data = make_level_data(
            i0, i1,
            t(rng.random((h, w, 1), dtype=np.float32)),
            v + t(0.1 * rng.standard_normal((h, w, 2)).astype(np.float32)),
            t(rng.random((h, w, 1), dtype=np.float32)),
            v + t(0.5 * rng.standard_normal((h, w, 2)).astype(np.float32)),
        )
        e_k, g_k, p_k = ks.sweep_grad(planes, v_lin, v, data, p)
        e_p, g_p, p_p = ks.sweep_grad_plain(planes, v_lin, v, data, p)
        compare("sweep_grad", e_p.reshape(1), e_k.reshape(1), shape + " energy", 1e-5, True)
        compare("sweep_grad", g_p, g_k, shape + " grad", 1e-5, True)
        compare("sweep_grad", p_p, p_k, shape + " precond", 1e-5, True)
        e2_k = ks.sweep_energy(planes, v_lin, v, data, p)
        e2_p = ks.sweep_energy_plain(planes, v_lin, v, data, p)
        compare("sweep_energy", e2_p.reshape(1), e2_k.reshape(1), shape, 1e-5, True)
        # the energy kernel and the gradient pass share one template
        require(abs(float(e2_k) - float(e_k)) <= 1e-6 * abs(float(e_k)),
                "sweep_energy and sweep_grad disagree on the energy")
        # fixed-order reductions: a rerun is bitwise identical
        e_k2, g_k2, p_k2 = ks.sweep_grad(planes, v_lin, v, data, p)
        require(float(e_k2) == float(e_k) and torch.equal(g_k2, g_k) and torch.equal(p_k2, p_k),
                "sweep_grad rerun is not bitwise identical")

        if full:
            timings = {
                "halfway_warp": (lambda: kw.halfway_warp(i0, i1, v_lin),
                                 lambda: kw.halfway_warp_plain(i0, i1, v_lin)),
                "bilinear_sample": (lambda: kw.bilinear_sample(stacked, p_co),
                                    lambda: kw.bilinear_sample_plain(stacked, p_co)),
                "sweep_grad": (lambda: ks.sweep_grad(planes, v_lin, v, data, p),
                               lambda: ks.sweep_grad_plain(planes, v_lin, v, data, p)),
                "sweep_energy": (lambda: ks.sweep_energy(planes, v_lin, v, data, p),
                                 lambda: ks.sweep_energy_plain(planes, v_lin, v, data, p)),
            }
            for name, (kern, plain) in timings.items():
                # plain, kernel, kernel, plain; the medians of each pair
                pl1, k1, k2, pl2 = cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)
                rec[name]["ms"] = float(np.median([k1, k2]))
                rec[name]["plain_ms"] = float(np.median([pl1, pl2]))
                log(f"  {name} 1024x1024 time: kernel {k1:.4f}/{k2:.4f} ms, "
                    f"plain {pl1:.4f}/{pl2:.4f} ms")
    return rec


def make_pair(n: int):
    """Frame 0 of the JAX bench's synthetic clip pair (a textured base and a
    Gaussian blob that moves from x = 0.45 n to 0.55 n), and its 4 points."""
    import bench

    clip_a, clip_b = bench._make_clips(1, n, n, seed=0)
    ys = np.linspace(n * 0.3, n * 0.7, 4)
    pts = np.stack(
        [np.stack([ys, np.full(4, n * 0.45)], -1), np.stack([ys, np.full(4, n * 0.55)], -1)], 1
    ).astype(np.float32)
    return clip_a[0], clip_b[0], pts


def centroids_x(frames) -> np.ndarray:
    """Content centroid x per frame: luminance above its median."""
    import torch

    lum = frames.mean(-1).reshape(frames.shape[0], -1)
    m = torch.clamp(lum - lum.median(dim=1, keepdim=True).values, min=0.0)
    xx = torch.arange(frames.shape[2], device=frames.device, dtype=frames.dtype)
    xx = xx.repeat(frames.shape[1])
    return ((m * xx).sum(1) / m.sum(1)).cpu().numpy()


def main_path(dev, card: str) -> dict:
    """Phase 3: the 1024 x 1024 pair morph through ``api.morph_pair``."""
    import torch

    from videomorphing_tpu_torch import api
    from videomorphing_tpu_torch.kernels import sweep as ks
    from videomorphing_tpu_torch.kernels import warp as kw

    n, n_frames = 1024, 16
    i0, i1, pts = make_pair(n)
    counters = (kw.halfway_warp, kw.bilinear_sample, ks.sweep_grad, ks.sweep_energy)
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    frames = api.morph_pair(i0, i1, pts, n_frames=n_frames, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    log(f"  launches in the main path: {launches}")

    require(tuple(frames.shape) == (n_frames, n, n, 3), f"frames have shape {tuple(frames.shape)}")
    require(frames.device.type == "cuda", "frames are not on the card")
    require(bool(torch.isfinite(frames).all()), "non-finite frames")
    require(float(frames.min()) >= 0.0 and float(frames.max()) <= 1.0, "frames leave [0, 1]")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} was not launched on the main path")
    cx = centroids_x(frames)
    ca, cb = centroids_x(torch.from_numpy(np.stack([i0, i1])).to(dev))
    log(f"  centroid x per frame: {np.round(cx, 2).tolist()} (A {ca:.2f}, B {cb:.2f})")
    require(np.all(np.diff(cx) >= 0.0), "centroid does not move monotonically")
    require(abs(cx[0] - ca) < 0.01 * n and abs(cx[-1] - cb) < 0.01 * n, "centroid misses A or B")
    art = api.solve_pair(i0, i1, pts, device=dev)
    iters = sum(s.iters for s in art.result.level_stats)
    for lvl, s in enumerate(art.result.level_stats):
        log(f"  level {lvl} (coarse->fine): iters={s.iters} e0={s.e0:.6f} e_final={s.e_final:.6f}")
        require(s.e_final < s.e0, f"level {lvl}: energy did not decrease")
    log(f"  pair_1k: wall {wall:.3f} s for solve + {n_frames} frames, "
        f"{iters} iterations, {n_frames / wall:.3f} frames/s on {card}")
    return launches


def golden_translation(dev) -> float:
    """Phase 4: translation golden case (numpy rebuild of the reference's
    ``utils/golden.translation_case``): I1 = I0 shifted by 2u, u = (2.5, 4)."""
    import torch

    from videomorphing_tpu_torch import api
    from videomorphing_tpu_torch.models.image_morph import ImageMorpher
    from videomorphing_tpu_torch.ops.ssim import dssim_map

    h = w = 256
    uy, ux = 2.5, 4.0
    rng = np.random.default_rng(0)
    c, k = 3, 24
    period = np.exp(rng.uniform(np.log(10.0), np.log(80.0), (c, k)))
    ang = rng.uniform(0.0, 2 * np.pi, (c, k))
    psi = rng.uniform(0.0, 2 * np.pi, (c, k))
    amp = rng.uniform(0.5, 1.0, (c, k))
    amp = 0.48 * amp / amp.sum(1, keepdims=True)
    omega = 2 * np.pi / period
    wy, wx = omega * np.sin(ang), omega * np.cos(ang)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)

    def tex(yy, xx):
        ph = yy[..., None, None] * wy + xx[..., None, None] * wx + psi
        return (0.5 + (amp * np.cos(ph)).sum(-1)).astype(np.float32)

    i0, i1, mid = tex(ys, xs), tex(ys - 2 * uy, xs - 2 * ux), tex(ys - uy, xs - ux)
    crop = int(np.ceil(2 * max(abs(uy), abs(ux)))) + 12
    art = api.solve_pair(i0, i1, device=dev)
    t = lambda a: torch.from_numpy(a).to(dev)
    frame = ImageMorpher(device=str(dev)).render_one(t(i0), t(i1), art, 0.5)
    sl = (slice(crop, -crop), slice(crop, -crop))
    ssim = 1.0 - float(torch.mean(dssim_map(frame[sl], t(mid)[sl])))
    v_err = float(torch.linalg.norm(art.v[sl] - torch.tensor([uy, ux], device=dev), dim=-1).mean())
    log(f"  golden translation 256x256: midpoint SSIM {ssim:.5f}, mean field error {v_err:.4f} px")
    require(ssim >= 0.99, f"golden midpoint SSIM {ssim} < 0.99")
    return ssim


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from videomorphing_tpu_torch.device import require_cuda
    from videomorphing_tpu_torch.kernels import build

    kernels_only = "--kernels" in argv
    dev = require_cuda()
    card = card_line()
    log(f"phase 0: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(card)

    log("phase 1: build")
    t0 = time.perf_counter()
    build.load()
    log(f"  kernels built and loaded in {time.perf_counter() - t0:.2f} s from {build.library_path()}")
    for line in (build.library_path().parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas: " + line.strip())

    log("phase 2: kernels against their plain versions")
    rec = check_kernels(dev)

    if kernels_only:
        log(json.dumps(rec))
        return 0
    log("phase 3: main path (api.morph_pair, 1024x1024, 4 points, 16 frames)")
    launches = main_path(dev, card)
    log("phase 4: golden translation")
    golden_translation(dev)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = rec[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
        })
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
