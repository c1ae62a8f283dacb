#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``videomorphing_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --kernels  # phases 0-2 only; prints no result line

Phases:
  0. the card: ``require_cuda()`` and its name and power limit from nvidia-smi;
  1. build the CUDA kernels of ``videomorphing_tpu_torch/csrc`` with nvcc;
  2. each kernel against its plain PyTorch version on the card, at the
     slices' shapes (1024 x 1024 and a ragged 135 x 241, C = 3; the sampler
     also at C = 4 on the stacked [disp, v] planes, on a grey 540 x 960
     image, at 4 points, and batched: 29 and 58 grey 540 x 960 images as
     the flow warps take them, 29 two-channel 540 x 960 and 1080 x 1920
     flows as the occlusion round trip takes them), with the median time
     of kernel and plain version (CUDA events);
  3. the pair path: ``api.morph_pair`` on a 1024 x 1024 pair with 4 point
     constraints and 16 frames, with every kernel's launch count;
  4. the golden translation at 256 x 256: the midpoint frame against its
     analytic truth (SSIM >= 0.99);
  5. the video path: ``api.morph_clips`` on the JAX bench's 30-frame
     1080 x 1920 clip pair with 4 points and default parameters, with every
     kernel's launch count, each stage's wall and frames/s;
  6. determinism: ``solve_clip_fields`` twice on a 6-frame 270 x 480 clip
     gives bitwise equal fields.

Any failure raises and exits non-zero. The second-to-last line is one JSON
object with a record per kernel (launches summed over phases 3 and 5); the
last line is ``{"ok": true, "device": {...}}``. With no CUDA device it exits
1 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# the kernel numbering of PERF.md and ROADMAP.md: 1 sweep_grad, 2 sweep_energy,
# 3 halfway_warp, 4 bilinear_sample (and its batched form)
KERNELS = {
    "halfway_warp": ("videomorphing_tpu_torch/csrc/warp.cu", "videomorphing_tpu/pallas/warp.py:206"),
    "bilinear_sample": ("videomorphing_tpu_torch/csrc/warp.cu", "videomorphing_tpu/pallas/warp.py:311"),
    "bilinear_sample_batched": ("videomorphing_tpu_torch/csrc/warp.cu", "videomorphing_tpu/pallas/warp.py:311"),
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
                rec[name]["ms"], rec[name]["plain_ms"], (k1, k2, pl1, pl2) = timed_pair(kern, plain)
                log(f"  {name} 1024x1024 time: kernel {k1:.4f}/{k2:.4f} ms, "
                    f"plain {pl1:.4f}/{pl2:.4f} ms")
    check_sampler_forms(dev, compare, rec, t)
    return rec


def timed_pair(kern, plain, reps: int = 20):
    """Median ms of kernel and plain version, run plain, kernel, kernel,
    plain; returns (kernel ms, plain ms, the four readings)."""
    pl1, k1, k2, pl2 = cuda_ms(plain, reps), cuda_ms(kern, reps), cuda_ms(kern, reps), cuda_ms(plain, reps)
    return float(np.median([k1, k2])), float(np.median([pl1, pl2])), (k1, k2, pl1, pl2)


def check_sampler_forms(dev, compare, rec, t) -> None:
    """Phase 2, kernel 4 at the video path's shapes: the single form on a
    grey image and at 4 points, the batched form as the flow warps (n = 29
    and the 2(T-1) = 58 of one clip's batch, grey 540 x 960) and the
    occlusion round trip (n = 29 two-channel flows at 540 x 960 and at
    1080 x 1920) call it, each with kernel and plain times (10 calls per
    reading). Tolerance 1e-6 of max|ref| (bitwise expected: the lerps
    round as the plain version's separate operations). The flow warps'
    58-image case gives the batched form's record."""
    import torch

    from videomorphing_tpu_torch.kernels import warp as kw

    rng = np.random.default_rng(5)
    h, w = 540, 960
    grey = t(255.0 * rng.random((h, w), dtype=np.float32))
    co = (t(np.stack(np.mgrid[0:h, 0:w], -1)) + t(smooth_field(h, w, 3.0, 3))).contiguous()
    flow = t(smooth_field(1080, 1920, 4.0, 4))
    pts = t(np.stack([rng.uniform(-3, 1083, 4), rng.uniform(-3, 1923, 4)], -1))
    cases = [("bilinear_sample", "540x960 grey", grey, co), ("bilinear_sample", "4 points on 1080x1920x2", flow, pts)]
    for n, (hh, ww), c in ((29, (h, w), 1), (58, (h, w), 1), (29, (h, w), 2), (29, (1080, 1920), 2)):
        gg = t(np.stack(np.mgrid[0:hh, 0:ww], -1))
        imgs = torch.stack([t(255.0 * rng.random((hh, ww, c), dtype=np.float32)) for _ in range(n)])
        coords = torch.stack([gg + t(smooth_field(hh, ww, 3.0, 10 + k)) for k in range(n)])
        cases.append(("bilinear_sample_batched", f"{n}x{hh}x{ww}x{c}", imgs, coords))
    for name, shape, img, coords in cases:
        kern = getattr(kw, name)
        plain = getattr(kw, name + "_plain")
        compare(name, plain(img, coords), kern(img, coords), shape, 1e-6, True)
        ms, plain_ms, (k1, k2, pl1, pl2) = timed_pair(lambda: kern(img, coords), lambda: plain(img, coords), 10)
        log(f"  {name} {shape} time: kernel {k1:.4f}/{k2:.4f} ms, plain {pl1:.4f}/{pl2:.4f} ms")
        if shape == f"58x{h}x{w}x1":
            rec[name]["ms"], rec[name]["plain_ms"] = ms, plain_ms
    del cases
    torch.cuda.empty_cache()


def make_pair(n: int):
    """Frame 0 of the JAX bench's synthetic clip pair (a textured base and a
    Gaussian blob that moves from x = 0.45 n to 0.55 n), and its 4 points."""
    import bench

    clip_a, clip_b = bench._make_clips(1, n, n, seed=0)
    return clip_a[0], clip_b[0], bench_points(n, n)


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
    counters = (kw.halfway_warp, kw.bilinear_sample, kw.bilinear_sample_batched, ks.sweep_grad, ks.sweep_energy)
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    frames = api.morph_pair(i0, i1, pts, n_frames=n_frames, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    log(f"  launches in the pair path: {launches}")

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


def bench_points(h: int, w: int) -> np.ndarray:
    """The JAX bench's 4 point pairs for an h x w frame (``bench.py``
    ``_bench_pair``): one column of clip A's blob, one of clip B's."""
    ys = np.linspace(h * 0.3, h * 0.7, 4)
    return np.stack(
        [np.stack([ys, np.full(4, w * 0.45)], -1), np.stack([ys, np.full(4, w * 0.55)], -1)], 1
    ).astype(np.float32)


def blob_centroids_x(frames) -> np.ndarray:
    """Blob centroid x per frame of the bench clips (a static textured
    background with a horizontal gradient, and a Gaussian blob on the
    middle rows): luminance more than 0.1 above its column's mean over the
    top and bottom fifths of the frame. The background gradient dominates
    ``centroids_x``, and the render's screened-Poisson blend shifts that
    measure by a fraction of a percent of the width, more than the blob's
    2 px per frame at 1080p; subtracting each column's background leaves
    the blob."""
    import torch

    lum = frames.mean(-1)
    band = lum.shape[1] // 5
    bg = torch.cat([lum[:, :band], lum[:, -band:]], 1).mean(1, keepdim=True)
    m = torch.clamp(lum - bg - 0.1, min=0.0).sum(1)
    xx = torch.arange(lum.shape[2], device=frames.device, dtype=frames.dtype)
    return ((m * xx).sum(1) / m.sum(1)).cpu().numpy()


def video_path(dev, card: str) -> dict:
    """Phase 5: the 30-frame 1080 x 1920 clip morph through
    ``api.morph_clips`` with default parameters and 4 points."""
    import torch

    import bench
    from videomorphing_tpu_torch import api
    from videomorphing_tpu_torch.config import VideoParams
    from videomorphing_tpu_torch.kernels import sweep as ks
    from videomorphing_tpu_torch.kernels import warp as kw
    from videomorphing_tpu_torch.utils import profiling

    t_len, h, w = 30, 1080, 1920
    clip_a, clip_b = bench._make_clips(t_len, h, w, seed=0)
    pts = bench_points(h, w)
    ca = torch.from_numpy(clip_a).to(dev)
    cb = torch.from_numpy(clip_b).to(dev)
    del clip_a, clip_b
    counters = (kw.halfway_warp, kw.bilinear_sample, kw.bilinear_sample_batched, ks.sweep_grad, ks.sweep_energy)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    with profiling.record_phases() as rec:
        res = api.morph_clips(ca, cb, pts, device=dev)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    log(f"  launches in the video path: {launches}")

    frames = res.frames
    require(tuple(frames.shape) == (t_len, h, w, 3), f"frames have shape {tuple(frames.shape)}")
    require(frames.device.type == "cuda", "frames are not on the card")
    require(bool(torch.isfinite(frames).all()), "non-finite frames")
    require(float(frames.min()) >= 0.0 and float(frames.max()) <= 1.0, "frames leave [0, 1]")
    require(bool(torch.isfinite(res.fields).all()), "non-finite fields")
    warm = rec["warm_iters"]
    log(f"  warm iterations per frame: {warm}; cold + warm total {res.solve_iters}")
    fine = VideoParams().warm_iters_fine
    require(len(warm) == t_len - 1 and all(1 <= k <= fine for k in warm),
            f"warm frames ran outside [1, {fine}] iterations")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} was not launched on the video path")
    stages = ("flows", "tracking", "cold_solve", "warm_loop", "bulges", "confidences", "render")
    log("  stage walls (s): " + ", ".join(f"{k} {rec[k]:.3f}" for k in stages)
        + f"; total {wall:.3f}")
    log(f"  video_1080p: wall {wall:.3f} s for {t_len} frames, {t_len / wall:.3f} frames/s, "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
    cx = np.concatenate([blob_centroids_x(frames[k:k + 10]) for k in range(0, t_len, 10)])
    ca0 = blob_centroids_x(ca[:1])[0]
    cb_end = blob_centroids_x(cb[-1:])[0]
    log(f"  blob centroid x per frame: {np.round(cx, 2).tolist()} "
        f"(A[0] {ca0:.2f}, B[{t_len - 1}] {cb_end:.2f})")
    require(np.all(np.diff(cx) > 0.0), "blob centroid does not rise monotonically")
    require(abs(cx[0] - ca0) < 0.01 * w and abs(cx[-1] - cb_end) < 0.01 * w,
            "blob centroid misses clip A's first or clip B's last frame")
    return launches


def determinism(dev) -> None:
    """Phase 6: two solves of one 6-frame 270 x 480 clip pair are bitwise
    equal (the reference's ``tests/test_determinism.py`` contract)."""
    import torch

    import bench
    from videomorphing_tpu_torch.video.pipeline import solve_clip_fields

    clip_a, clip_b = bench._make_clips(6, 270, 480, seed=1)
    ca = torch.from_numpy(clip_a).to(dev)
    cb = torch.from_numpy(clip_b).to(dev)
    pts = torch.from_numpy(bench_points(270, 480)).to(dev)
    a = solve_clip_fields(ca, cb, pts)[0]
    b = solve_clip_fields(ca, cb, pts)[0]
    require(torch.equal(a, b), f"reruns differ by {float((a - b).abs().max())} px")
    log(f"  solve_clip_fields 6x270x480 twice: bitwise equal (max |v| {float(a.abs().max()):.3f} px)")


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
    log("phase 3: pair path (api.morph_pair, 1024x1024, 4 points, 16 frames)")
    launches = main_path(dev, card)
    log("phase 4: golden translation")
    golden_translation(dev)
    log("phase 5: video path (api.morph_clips, 30 frames of 1080x1920, 4 points)")
    video_launches = video_path(dev, card)
    log("phase 6: determinism")
    determinism(dev)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = rec[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name] + video_launches[name], "max_abs_err": r["max_abs_err"],
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
