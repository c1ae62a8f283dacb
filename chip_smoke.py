#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``videomorphing_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --kernels  # phases 0-2 only; prints no result line

Phases:
  0. the card: ``require_cuda()`` and its name and power limit from nvidia-smi;
  1. build the CUDA kernels of ``videomorphing_tpu_torch/csrc`` with nvcc;
     print ptxas's registers and spills per kernel (``-Xptxas -v``, from
     ``build.log``) and each sweep kernel's registers, shared memory and
     resident blocks per SM (``vm_sweep_kernel_info``: every instantiated
     radius, the gradient kernel's tile at 0-2 and strip at 3-7, the energy
     kernel's tile at 0-3 and strip at 4-7, the wide strip at 8, 16 and
     its reach, and the per-pixel chain past it, each in its float32 and
     bf16 instantiation), and check the partials counts the wrapper sizes
     against ``vm_sweep_n_partials`` at every radius;
  2. each kernel against its plain PyTorch version on the card, at the
     slices' shapes (1024 x 1024, 1080 x 1920 and a ragged 135 x 241,
     C = 3; kernels 1-2 also at every ``ssim_window`` of ``WINDOW_SIGMA``,
     1-17, 33, 49 and 51, on the ragged shape (every instantiated radius,
     the wide strip at R = 8, 16 and its reach 24, the per-pixel chain
     past it) and at ``WIDE_WINDOWS`` (1, 7-17) at 1024^2, timed in both
     forms, each rerun bitwise;
     the sampler, bitwise, also at C = 4 on
     the stacked [disp, v] planes, on a grey 540 x 960 image, at 4 points,
     and batched: 29 and 58 grey 540 x 960 images as the flow warps take
     them, 29 two-channel 540 x 960 and 1080 x 1920 flows as the occlusion
     round trip takes them, 2 four-channel 1080 x 1920 frames as the render
     takes them; then at C = 1, 2, 3, 4 and 5 on 540 x 960 and 135 x 241,
     single and batched, each also from a misaligned contiguous copy, which
     must take the scalar instantiation), with each kernel's device time
     (``graph_ms``: its calls captured in a CUDA graph, CUDA events around
     the replays, so the wrapper's host work is left out) beside its call
     time (``cuda_ms``: CUDA events around one call, host work included)
     and the plain version's call time (kernels 1-2 at 1024^2 and at
     1080 x 1920, the warm loop's level), each kernel's bound (the larger of
     its bytes over 3.35 TB/s and its operations over 67 TFLOP/s) and, for
     the sampler, the device and call times of ``F.grid_sample`` on the same
     image and map as a yardstick; then the row-shard forms (the shard
     sweeps and the row-offset warp) on 4 row blocks of a 2160 x 3840,
     C = 3 level and on 2 (phase 16's blocks) against the whole-frame
     kernels' rows, and against their plain versions there and on a
     ragged 132 x 241 split 4 ways (at every window); the 4-block split
     also at ``WIDE_WINDOWS``, timed (in bf16 at
     ``WIDE_BF16_SHARD_WINDOWS``); and the bf16 forms of kernels 1-3
     (``pack_dtype="bfloat16"``: bf16 planes and maps, v_lin rounded to
     bf16) against their plain bf16 versions at the same shapes and
     windows (the 4K splits at the default window), and at windows 3, 5
     and 11 also on 135 x 242, 135 x 243 and 135 x 244
     (``BF16_PARITY_HW``: every width mod 4 with the ragged shape, odd and
     even h w) and on 4 row blocks of 132 x 243 and 132 x 242
     (``BF16_PARITY_SHARD_HW``, shard rows against the whole frame's), where
     the bf16 forms' word staging could pick the wrong half; kernels 1-2 in
     both forms where the energy strip's walk of 16 rows meets the image's
     edges (``ENERGY_STRIP_HW``: 17 x 30 and 53 x 37 at windows 9-15, and
     ``BF16_PARITY_SHARD_HW``'s splits at windows 9, 11 and 15); kernel 3's bf16 output
     bitwise its float32 output cast, shard rows and reruns bitwise, with
     times and bounds (planes and maps at 2 bytes) beside the float32
     forms' at 1024^2, 1080 x 1920 and the 4K block;
  3. the pair path: ``api.morph_pair`` on a 1024 x 1024 pair with 4 point
     constraints and 16 frames, with every kernel's launch count;
  4. the golden cases (``utils.golden.run_golden``: translation, rotation
     and scale at 256 x 256): midpoint SSIM >= 0.99 each, and a mean field
     error < 0.1 px for the translation;
  5. the video path: ``api.morph_clips`` on the JAX bench's 30-frame
     1080 x 1920 clip pair with 4 points and default parameters, with every
     kernel's launch count, each stage's wall and frames/s;
  6. determinism: ``solve_clip_fields`` twice on a 6-frame 270 x 480 clip
     gives bitwise equal fields;
  7. the layered pair path: ``api.morph_pair_layered`` on phase 3's inputs
     with one layer on the blob's disc, 16 frames;
  8. the layered video path: ``api.morph_clips_layered`` on phase 5's clip
     pair and points with one layer whose per-frame masks follow the blob,
     with every kernel's launch count, each stage's wall and frames/s; then
     kernel 4 against its plain version at the layer warp's shape;
  9. the command line, in child processes: ``cli video`` on a 6-frame
     270 x 480 ``.vmc`` pair with a field store, twice (the second run
     resumes and writes the same bytes), and ``cli project`` on a layered
     clip project;
 10. the spatial pair at 4K: frame 0 of the bench's 2160 x 3840 clip pair
     and its 4 points through ``parallel.spatial.optimize_pair_spatial`` on
     4 row blocks of one card, then 16 rendered frames; the same pair
     through the single-device ``api.solve_pair``; one 1080 x 1920 level,
     6 iterations, sharded against single-device;
 11. the mesh video path: ``api.morph_clips`` on phase 5's clip pair with a
     3-device mesh of the one card (blocks of 10 frames), its sharded flows
     against ``clip_flows`` and its render against the sequential render
     of the same fields;
 12. the manifest at 4K: ``parallel.batch.run_manifest`` on three jobs of
     2160 x 3840 pairs (4 points and 4 frames, no points and 4 frames, 4
     points and 2 frames) over a 2-device mesh of the card, each job
     bitwise equal to ``api.morph_pair`` of it;
 13. the streamed clip pair at 4K: 6 frames of 2160 x 3840 as ``.vmc``
     stores through the native reader (required) and
     ``StreamingBatchRunner.run_clip_pair`` on a 2-device mesh of the card,
     each frame bitwise equal to its pair's own morph, with the runner's
     decode / H2D / dispatch / fetch sums; then ``cli batch`` in child
     processes (``--clip-a/--clip-b`` and ``--manifest``) at 270 x 480,
     byte for byte against the in-process calls;
 14. the stressor (``utils.stressor``): the robust-flow morph beats the
     cross-dissolve at 4 x 72 x 104, and the flow, occlusion and midframe
     metrics at 8 x 480 x 854 (printed, no gate);
 15. the edit session at 1024 x 1024: ``edit.PointEditor`` on phase 3's
     pair, driven by a script (4 points, a cold solve, a 3 px move and a
     warm solve, a preview, a cursor session that places a fifth pair and
     solves, a 16-frame ``.npz`` render, save) with ANSI previews of 160
     columns; the warm solve launches fewer gradient kernels than the cold
     one, the field equals an ``api.Session`` given the same edits, the
     halfway view the plain sampler's and the frames ``Session.render``,
     each bitwise;
 16. pairs x rows at 4K: ``make_spatial_level_solver(batch_axis="batch")``
     on frame 0 of four 2160 x 3840 clip pairs (B = 4, 6 iterations, the
     bench's points) over a (2, 2) ("batch", "y") mesh of the card, each
     pair bitwise equal to the 1-D solver on a (2,) mesh, then a t = 0.5
     render of each pair;
 17. the examples: both port demos' compute functions at their default
     shapes on the card, their own checks and their ``.y4m`` files;
 18. the wide windows: ``api.morph_pair`` on phase 3's inputs at
     ``ssim_window`` 11, 1 and 17 (17 also in bf16: the wide strip) and
     ``run_golden`` at 11, and phase 10's 4K pair through
     ``optimize_pair_spatial`` on 4 row blocks at windows 9 and 17, its
     field bitwise equal to the single-device ``api.solve_pair``;
 19. the bf16 pack (``pack_dtype="bfloat16"``, ``backend="auto"``):
     ``api.morph_pair`` on phase 3's inputs (endpoints, a bitwise rerun,
     the field against phase 3's), ``api.morph_clips`` on phase 5's clip
     pair, phase 10's 4K pair through ``optimize_pair_spatial`` on 4 row
     blocks and ``run_golden``, each with its wall, launches and the form
     of every level: float32 under ``pallas_min_pixels`` (16384) pixels,
     bf16 from there (``record_forms``);
 20. the bench (``videomorphing_tpu_torch.bench``): ``python -m
     videomorphing_tpu_torch.cli bench`` in a child process (the twin of
     ``vmorph bench``: video_1080p, 30 frames of 1080 x 1920, 3 repeats,
     with the kernel and golden checks), then ``bench.main([config])`` in
     this process for ``BENCH_PATH_CONFIGS`` and last for ``kernels``; each
     line has its config's keys (``bench.LINE_KEYS``) and a positive
     value, the kernels are compiled and within ``bench.KERNEL_TOLERANCE``
     (phase 2's tolerances) of their plain versions, the golden SSIM is
     0.99 or more, and the four kernels' counters rise, on the path and in
     the ``kernels`` check (counted apart: comparisons);
 21. the render's CUDA graphs (``render_graphs``): ``synth.render.
     render_frame`` replays a captured graph of its body, bitwise the eager
     body, at 1024 x 1024 (C = 3, a bulge, no confidences) and 1080 x 1920
     (C = 4, a bulge and both confidences) at ``RENDER_GRAPH_TIMES``, one
     capture a signature, kernel 4's counters advancing by the captured
     launches on each replay; a replay after the constant caches were
     cleared and refilled by frames of other shapes; a TF32 flip, which
     captures a graph of its own; bicubic sampling, the linear blend and
     non-contiguous inputs at 512 x 512; ``with_aux`` runs eagerly; the
     ``graph_captures``/``graph_replays`` counters of the ``render.frame``
     span; each frame's call time replayed and eager.
 22. the level solver's CUDA graphs (``solver_graphs``): each level of
     ``SOLVER_GRAPH_CASES`` (64^2, 1024^2, 1080 x 1920 and 2160 x 3840; 2
     and 4 colours, the bf16 pack, a re-warp every iteration, the median
     off) solved eagerly (``eager_levels``) and twice as graph replays, the
     field and every ``LevelStats`` field bitwise, one capture a key, the
     span's ``graph_iters`` its iterations and its ``reads`` its Armijo
     trials, the kernels' counters as the eager loop's (the capture's
     warm-up beside); ``optimize_pair`` at ``SOLVER_GRAPH_PAIR_N``^2 and the
     video's warm solve at ``SOLVER_GRAPH_VIDEO_HW`` the same way, a second
     morph capturing nothing; the 4K pair's 8-level solve with its peak
     memory and the memory its graphs keep; each solve's wall both ways.
 23. the flows' sweep (``flow_sweeps``): kernel 5 (``kernels.flow.hs_sweep``)
     bitwise its plain version on the card, one sweep and a chain of
     sweeps through two buffers, at ``FLOW_SWEEP_SHAPES`` (clip30's six
     flow levels with its 58 problems, and ragged shapes); its device time
     at the finest level beside its bound (40 bytes a site over 3.35 TB/s),
     at 60 % of it or better, and the plain version's call time; then
     ``clip_flows`` of phase 5's clip A bitwise a run with every sweep in
     eager operations, one launch a sweep and each ``flow.level`` span's
     ``fused_sweeps`` its sweeps, both walls; only the ``clip_flows`` runs
     count launches.

A repeated-device mesh runs its blocks one after another on the card: a
correctness path, not a speed-up. Any failure raises and exits non-zero.
The card's name and power limit, then one JSON object with a record per
kernel, the bf16 forms and the wide strip's launches of kernels 1, 2, 1s
and 2s (``<name>_wide``, timed at window 17) as records of their own
(launches summed over the paths of phases 3-5, 7, 8 and 10-23;
``ms`` and ``library_ms`` device times, ``plain_ms`` a call time), are the
lines before the last; the last line is ``{"ok": true, "device":
{...}}``. With no CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def wide_name(name: str) -> str:
    """The record of the wide strip's launches of kernel record ``name``:
    ``sweep_grad_bf16`` -> ``sweep_grad_wide_bf16``."""
    base = name.removesuffix("_bf16")
    return base + "_wide" + name[len(base):]


# the kernel numbering of PERF.md and ROADMAP.md: 1 sweep_grad (shard form
# sweep_grad_shard), 2 sweep_energy (sweep_energy_shard), 3 halfway_warp (its
# row-offset form halfway_warp_rows), 4 bilinear_sample (and its batched form),
# 5 hs_sweep (the flows' Jacobi sweep);
# a name ending in _bf16 is the bf16 form of kernels 1-3 (pack_dtype =
# "bfloat16"), counted under launches_bf16 of the same wrapper
KERNELS = {
    "halfway_warp": ("videomorphing_tpu_torch/csrc/warp.cu", "videomorphing_tpu/pallas/warp.py:206"),
    "halfway_warp_rows": ("videomorphing_tpu_torch/csrc/warp.cu", "videomorphing_tpu/pallas/warp.py:206"),
    "bilinear_sample": ("videomorphing_tpu_torch/csrc/warp.cu", "videomorphing_tpu/pallas/warp.py:311"),
    "bilinear_sample_batched": ("videomorphing_tpu_torch/csrc/warp.cu", "videomorphing_tpu/pallas/warp.py:311"),
    "sweep_grad": ("videomorphing_tpu_torch/csrc/sweep.cu", "videomorphing_tpu/pallas/sweep.py:293"),
    "sweep_energy": ("videomorphing_tpu_torch/csrc/sweep.cu", "videomorphing_tpu/pallas/sweep.py:502"),
    "sweep_grad_shard": ("videomorphing_tpu_torch/csrc/sweep.cu", "videomorphing_tpu/pallas/sweep.py:936"),
    "sweep_energy_shard": ("videomorphing_tpu_torch/csrc/sweep.cu", "videomorphing_tpu/pallas/sweep.py:959"),
    "hs_sweep": ("videomorphing_tpu_torch/csrc/flow.cu", "none: videomorphing_tpu/video/flow.py _hs_level is jnp"),
}
BF16_FORMS = ("halfway_warp", "halfway_warp_rows", "sweep_grad", "sweep_energy", "sweep_grad_shard",
              "sweep_energy_shard")
KERNELS.update({f"{name}_bf16": KERNELS[name] for name in BF16_FORMS})
# the wide strip (sweep_wide_kernel, SSIM windows 17 up): a launch of kernel
# 1 or 2 that runs it counts under its wrapper's launches (or launches_bf16)
# and also under launches_wide (launches_wide_bf16), its record <name>_wide
# (<name>_wide_bf16); timed at WIDE_RECORD_WINDOW
WIDE_FORMS = ("sweep_grad", "sweep_energy", "sweep_grad_bf16", "sweep_energy_bf16", "sweep_grad_shard",
              "sweep_energy_shard")
KERNELS.update({wide_name(name): KERNELS[name] for name in WIDE_FORMS})
WIDE_RECORD_WINDOW = 17
# the shapes of the phases that this slice adds (phase 2's shard forms,
# phases 10 and 11); module constants so a rehearsal can shrink them
SHARD_SHAPES = ((2160, 3840), (132, 241))
SPATIAL_HW = (2160, 3840)
MESH_VIDEO_THW = (30, 1080, 1920)
# the shapes of phases 4 and 12-14 (the batch tier and the quality gates)
GOLDEN_HW = (256, 256)
MANIFEST_HW = (2160, 3840)
STREAM_THW = (6, 2160, 3840)
CLI_BATCH_THW = (6, 270, 480)
STRESSOR_GATE_THW = (4, 72, 104)
STRESSOR_FULL_THW = (8, 480, 854)
# the shapes of phases 15 and 16 (the editor and the pairs x rows layout:
# PAIRS_ROWS_BLOCKS row blocks a pair, which phase 2 also holds)
EDIT_N = 1024
PAIRS_ROWS_HW = (2160, 3840)
PAIRS_ROWS_BLOCKS = 2
# the SSIM windows (ssim_window: ssim_sigma) that phase 2 holds the sweeps
# at on its ragged shapes: every instantiated radius (0-7), the wide strip's
# first radius (8, window 17), one between (16, window 33) and its reach
# (24, window 49), and the per-pixel chain's first (25, window 51);
# WIDE_WINDOWS are also held and timed at 1024^2 and on 4 row blocks of
# the 4K level (WIDE_BF16_SHARD_WINDOWS there in bf16 too); phase 18 runs
# the pair and the golden cases at WIDE_PAIR_WINDOW, the pair also at
# WIDE_PAIR_WINDOWS (the last in bf16 too), and the 4K spatial solve at
# WIDE_SPATIAL_WINDOWS
WINDOW_SIGMA = {1: 1.0, 3: 1.0, 5: 1.0, 7: 1.5, 9: 1.5, 11: 1.5, 13: 2.0, 15: 2.5, 17: 3.0, 33: 5.0, 49: 8.0,
                51: 8.0}
WIDE_WINDOWS = (1, 7, 9, 11, 13, 15, 17)
WIDE_BF16_SHARD_WINDOWS = (1, 9, 11, 17)
WIDE_PAIR_WINDOW = 11
WIDE_PAIR_WINDOWS = (1, 17)
WIDE_SPATIAL_WINDOWS = (9, 17)
WIDE_PAIR_N = 1024
# phase 20's configs of the port's bench run in this process (the headline,
# video_1080p, runs in a child process; kernels runs apart, its launches
# being comparisons), and the kernels whose counters the kernels check raises
BENCH_PATH_CONFIGS = ("pair_256", "pair_1k", "video_480p", "golden", "batch_4k", "batch_4k_stream")
BENCH_CHECKED = ("sweep_grad", "sweep_energy", "halfway_warp", "bilinear_sample_batched")
# phase 19's clip pair (phase 5's), a module constant so a rehearsal can shrink it
BF16_VIDEO_THW = (30, 1080, 1920)
# phase 2's shapes for the bf16 forms' word staging (an element's half of
# its 4-byte word follows the parity of its flat index): whole frames of
# widths 2, 3 and 0 mod 4 beside the ragged 135 x 241 (1 mod 4; 135 x 241
# and 135 x 243 hold an odd h w), and 4 row blocks of 33 rows (blocks 1
# and 3 start on an odd row) of frames of odd and even width, each against
# the whole frame's rows; at the tile's, the energy kernel's and the
# strip's windows
BF16_PARITY_HW = ((135, 242), (135, 243), (135, 244))
BF16_PARITY_SHARD_HW = ((132, 243), (132, 242))
BF16_PARITY_WINDOWS = (3, 5, 11)
# phase 2's whole frames where the energy strip's walk of 16 rows meets
# the image's edges (heights under one walk, a pyramid level's width of
# 30), held with the ragged 135 x 241 at ENERGY_STRIP_WINDOWS, and the
# windows at which BF16_PARITY_SHARD_HW's 4-block splits of 33 rows hold
# the strip's row-shard form, both forms
ENERGY_STRIP_HW = ((17, 30), (53, 37))
ENERGY_STRIP_WINDOWS = (9, 11, 13, 15)
ENERGY_STRIP_SHARD_WINDOWS = (9, 11, 15)
# phase 22's levels ((h, w), MorphParams overrides, iterations), its whole
# pair solve and its video warm solve; module constants so a rehearsal can
# shrink them
SOLVER_GRAPH_CASES = (
    ((64, 64), {}, 40), ((64, 64), {"n_colors": 4, "relin_every": 1}, 30),
    ((1024, 1024), {}, 30), ((1024, 1024), {"n_colors": 4}, 30), ((1024, 1024), {"pack_dtype": "bfloat16"}, 30),
    ((1024, 1024), {"relin_every": 1, "relin_median": False}, 20),
    ((1080, 1920), {}, 30), ((1080, 1920), {"pack_dtype": "bfloat16", "n_colors": 4}, 20),
    ((2160, 3840), {}, 20), ((2160, 3840), {"pack_dtype": "bfloat16"}, 20),
)
SOLVER_GRAPH_PAIR_N = 1024
SOLVER_GRAPH_VIDEO_HW = (1080, 1920)
SOLVER_GRAPH_4K_HW = (2160, 3840)
# phase 23's shapes (h, w, batch): clip30's six flow levels (540 x 960 down,
# 2 x 29 frame pairs a clip), then ragged ones; the first is timed
FLOW_SWEEP_SHAPES = ((540, 960, 58), (270, 480, 58), (135, 240, 58), (68, 120, 58), (34, 60, 58), (17, 30, 58),
                     (17, 30, 3), (1, 5, 1))
FLOW_SWEEP_BYTES = 40       # a site: ut and u_w (8 each), it, ix, iy, denom (4 each), the new ut (8)
FLOW_SWEEP_OPS = 15         # a site: the average (4 + 4), the residual (5), the update (4); ~2 more
FLOW_SWEEP_MIN_SHARE = 0.6  # of its bound at the timed shape
BASE = ("halfway_warp", "bilinear_sample", "bilinear_sample_batched", "sweep_grad", "sweep_energy")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores


def bound(n_bytes: float, n_ops: float):
    """The least time (ms) the card could take, and what bounds it."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def sweep_bytes(c: int, with_grad: bool, plane_bytes: int) -> int:
    """Bytes per pixel of kernel 1 (``with_grad``) or 2, each input read once
    and each output written once: the 6C planes and the 6 values of the
    UI/TC maps at ``plane_bytes`` each (4, or 2 in the bf16 form), v and
    v_lin (float32), and kernel 1's grad and precond (float32)."""
    return plane_bytes * (6 * c + 6) + 4 * 4 + (4 * 4 if with_grad else 0)


def sweep_ops_per_pixel(c: int, k: int, with_grad: bool) -> int:
    """Arithmetic of the sweep kernels per owned pixel, counted from
    csrc/sweep.cu: per channel the linearized warps (8), two passes of 5
    window sums of k taps (20 k) and 3 products, the SSIM map (~20); with
    the gradient also the coefficient maps (~20), two passes of 4
    transposed sums (16 k), the chain through dw (10) and the curvature
    (8); then the curvature's window sum (4 k), the TPS maps and adjoint
    (~150) and the quadratic terms (~20). Halo recomputation not counted."""
    per_c = 8 + 20 * k + 3 + 20 + ((20 + 16 * k + 10 + 8) if with_grad else 0)
    rest = (4 * k + 150 + 20) if with_grad else (40 + 20)
    return c * per_c + rest


def warp_ops_per_pixel(c: int) -> int:
    """halfway_warp: per image the coordinates, clamp and floor (~10) and
    per channel 3 lerps of 3 operations and 2 derivatives of ~3."""
    return 2 * (10 + 15 * c)


def sample_ops_per_pixel(c: int) -> int:
    """bilinear_sample: coordinates (~10) and 3 lerps of 3 per channel."""
    return 10 + 9 * c


def grid_sample_call(imgs, coords):
    """Yardstick for kernel 4 (never called by the port): a call of
    ``F.grid_sample`` on the same n images (n, H, W, C) at the same maps
    (n, Ho, Wo, 2) in (y, x), normalized for ``align_corners=True``. It
    rounds differently, so it is a time, not a twin."""
    import torch
    import torch.nn.functional as F

    h, w = imgs.shape[1], imgs.shape[2]
    x = imgs.permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([coords[..., 1] * (2.0 / (w - 1)) - 1.0, coords[..., 0] * (2.0 / (h - 1)) - 1.0], -1)
    grid = grid.contiguous()
    return lambda: F.grid_sample(x, grid, mode="bilinear", padding_mode="border", align_corners=True)


def grid_sample_ms(imgs, coords) -> float:
    """Device time of the ``F.grid_sample`` yardstick (``graph_ms``)."""
    return graph_ms(grid_sample_call(imgs, coords), 10)


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
    """Median call time of ``fn()`` in ms: CUDA events around each call, so
    the host work of the call before its launches counts too (a few tens of
    microseconds for a kernel wrapper)."""
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


def graph_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of ``fn()`` in ms, its host work excluded: ``reps`` calls
    captured in one CUDA graph after ``warmup`` plain calls, CUDA events
    around each of 5 replays; the median replay over ``reps``. The inputs
    stay where the previous call left them (in L2 when they fit), as on
    the paths, where each kernel reads what the one before it wrote."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graph
    torch.cuda.empty_cache()
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
    BF16 = torch.bfloat16
    rec = {name: {"max_abs_err": 0.0, "max_rel_err": 0.0, "library_ms": None} for name in KERNELS}
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
        # a form without a record of its own (the wide strip's bf16 shard forms) keeps its errors apart
        r = rec.setdefault(name, {"max_abs_err": 0.0, "max_rel_err": 0.0, "library_ms": None})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["max_rel_err"] = max(r["max_rel_err"], rel)

    def check_sweeps(planes, v_lin, v, data, pw, shape):
        """Kernels 1-2 on v != v_lin with non-zero UI and TC maps: energy rel
        <= 1e-5, grad and precond max abs <= 1e-5 * max|ref| (float32 with
        other summation orders and contracted multiply-adds); the bf16 form
        (bf16 planes and maps) against its plain bf16 version alike."""
        sfx = "_bf16" if planes.dtype == BF16 else ""
        grad_name, energy_name = (sweep_record(n, pw) + sfx for n in ("sweep_grad", "sweep_energy"))
        e_k, g_k, p_k = ks.sweep_grad(planes, v_lin, v, data, pw)
        e_p, g_p, p_p = ks.sweep_grad_plain(planes, v_lin, v, data, pw)
        compare(grad_name, e_p.reshape(1), e_k.reshape(1), shape + " energy", 1e-5, True)
        compare(grad_name, g_p, g_k, shape + " grad", 1e-5, True)
        compare(grad_name, p_p, p_k, shape + " precond", 1e-5, True)
        del e_p, g_p, p_p
        e2_k = ks.sweep_energy(planes, v_lin, v, data, pw)
        e2_p = ks.sweep_energy_plain(planes, v_lin, v, data, pw)
        compare(energy_name, e2_p.reshape(1), e2_k.reshape(1), shape, 1e-5, True)
        # the energy kernel and the gradient pass share the per-pixel arithmetic
        require(abs(float(e2_k) - float(e_k)) <= 1e-6 * abs(float(e_k)),
                f"{shape}: sweep_energy and sweep_grad disagree on the energy")
        # fixed-order reductions: a rerun is bitwise identical
        e_k2, g_k2, p_k2 = ks.sweep_grad(planes, v_lin, v, data, pw)
        require(float(e_k2) == float(e_k) and torch.equal(g_k2, g_k) and torch.equal(p_k2, p_k),
                f"{shape}: sweep_grad rerun is not bitwise identical")
        require(float(ks.sweep_energy(planes, v_lin, v, data, pw)) == float(e2_k),
                f"{shape}: sweep_energy rerun is not bitwise identical")

    # every window of WINDOW_SIGMA on the ragged shape; the wide windows also at 1024^2
    windows = {k: p if k == p.ssim_window else MorphParams(ssim_window=k, ssim_sigma=sg)
               for k, sg in WINDOW_SIGMA.items()}
    for h, w in ((1024, 1024), (1080, 1920), (135, 241)):
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
        # inversion's) and C = 3 (colour samples): bitwise (the lerps round as
        # the plain version's separate operations)
        g = grid_coords(h, w, device=dev)
        stacked = torch.cat([v_lin * -0.5, v_lin], -1).contiguous()
        p_co = (g + 0.5 * v_lin).contiguous()
        compare("bilinear_sample", kw.bilinear_sample_plain(stacked, p_co),
                kw.bilinear_sample(stacked, p_co), shape + "x4", 0.0, False)
        phi = (g - v).contiguous()
        compare("bilinear_sample", kw.bilinear_sample_plain(i0, phi),
                kw.bilinear_sample(i0, phi), shape + "x3", 0.0, False)

        # constraint targets near v, so the four energy terms are of one
        # order and the energy comparison sees the SSIM term too
        data = make_level_data(
            i0, i1,
            t(rng.random((h, w, 1), dtype=np.float32)),
            v + t(0.1 * rng.standard_normal((h, w, 2)).astype(np.float32)),
            t(rng.random((h, w, 1), dtype=np.float32)),
            v + t(0.5 * rng.standard_normal((h, w, 2)).astype(np.float32)),
        )
        ragged = (h, w) == (135, 241)
        held = windows if ragged else {k: windows[k] for k in (5,) + (WIDE_WINDOWS if full else ())}
        for win, pw in held.items():
            check_sweeps(planes, v_lin, v, data, pw, f"{shape} window {win}")
            if full and win in WIDE_WINDOWS:
                record_wide(rec, win, time_wide_window(
                    h, w, pw,
                    lambda: ks.sweep_grad(planes, v_lin, v, data, pw),
                    lambda: ks.sweep_grad_plain(planes, v_lin, v, data, pw),
                    lambda: ks.sweep_energy(planes, v_lin, v, data, pw),
                    lambda: ks.sweep_energy_plain(planes, v_lin, v, data, pw)))

        # the bf16 form (pack_dtype="bfloat16") at the same windows: kernel 3's
        # bf16 output bitwise its float32 output cast, and within one bf16 step
        # of the largest value of its plain version (the float32 kernel and
        # plain version differ by up to 1e-6, which can move a rounding);
        # kernels 1-2 on those planes and the maps in bf16, with v_lin
        # rounded to bf16 as the solver's is
        vq = v_lin.to(BF16).float()
        planes16 = kw.halfway_warp(i0, i1, vq, BF16)
        require(torch.equal(planes16, kw.halfway_warp(i0, i1, vq).to(BF16)),
                f"halfway_warp {shape}: the bf16 output is not the float32 output cast")
        compare("halfway_warp_bf16", kw.halfway_warp_plain(i0, i1, vq, BF16).float(), planes16.float(), shape,
                2.0 ** -8, True)
        data16 = ks.pack_maps(data, BF16)
        for win, pw in held.items():
            check_sweeps(planes16, vq, v, data16, pw, f"{shape} window {win} bf16")
            if full and win in WIDE_WINDOWS:
                record_wide(rec, win, time_wide_window(
                    h, w, pw,
                    lambda: ks.sweep_grad(planes16, vq, v, data16, pw),
                    lambda: ks.sweep_grad_plain(planes16, vq, v, data16, pw),
                    lambda: ks.sweep_energy(planes16, vq, v, data16, pw),
                    lambda: ks.sweep_energy_plain(planes16, vq, v, data16, pw), plane_bytes=2))

        if (h, w) == (1080, 1920):
            # the warm loop's level: kernels 1-2 timed beside the 1024^2 shape,
            # both forms
            c, k = 3, int(p.ssim_window)
            npx = h * w
            for name, kern, nbytes, ops in (
                    ("sweep_grad", lambda: ks.sweep_grad(planes, v_lin, v, data, p),
                     npx * sweep_bytes(c, True, 4), npx * sweep_ops_per_pixel(c, k, True)),
                    ("sweep_energy", lambda: ks.sweep_energy(planes, v_lin, v, data, p),
                     npx * sweep_bytes(c, False, 4), npx * sweep_ops_per_pixel(c, k, False)),
                    ("sweep_grad_bf16", lambda: ks.sweep_grad(planes16, vq, v, data16, p),
                     npx * sweep_bytes(c, True, 2), npx * sweep_ops_per_pixel(c, k, True)),
                    ("sweep_energy_bf16", lambda: ks.sweep_energy(planes16, vq, v, data16, p),
                     npx * sweep_bytes(c, False, 2), npx * sweep_ops_per_pixel(c, k, False))):
                k1, k2, call = graph_ms(kern), graph_ms(kern), cuda_ms(kern)
                b_ms, b_by = bound(nbytes, ops)
                log(f"  {name} {shape} time: kernel {k1:.4f}/{k2:.4f} ms (device), {call:.4f} ms (call); "
                    f"bound {b_ms:.4f} ms ({b_by})")
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
                "halfway_warp_bf16": (lambda: kw.halfway_warp(i0, i1, vq, BF16),
                                      lambda: kw.halfway_warp_plain(i0, i1, vq, BF16)),
                "sweep_grad_bf16": (lambda: ks.sweep_grad(planes16, vq, v, data16, p),
                                    lambda: ks.sweep_grad_plain(planes16, vq, v, data16, p)),
                "sweep_energy_bf16": (lambda: ks.sweep_energy(planes16, vq, v, data16, p),
                                      lambda: ks.sweep_energy_plain(planes16, vq, v, data16, p)),
            }
            for name, (kern, plain) in timings.items():
                rec[name]["ms"], rec[name]["plain_ms"], (k1, k2, pl1, pl2), call = timed_pair(kern, plain)
                log(f"  {name} 1024x1024 time: kernel {k1:.4f}/{k2:.4f} ms (device), {call:.4f} ms (call), "
                    f"plain {pl1:.4f}/{pl2:.4f} ms")
            # bounds at the timed shapes: each input read once, each output
            # written once (float32; the bf16 form's planes and maps 2 bytes),
            # and the kernels' arithmetic
            c, k = 3, int(p.ssim_window)
            npx = h * w
            for sfx, pb in (("", 4), ("_bf16", 2)):
                rec["halfway_warp" + sfx]["bound"] = bound(npx * (4 * (2 * c + 2) + pb * 6 * c),
                                                           npx * warp_ops_per_pixel(c))
                rec["sweep_grad" + sfx]["bound"] = bound(npx * sweep_bytes(c, True, pb),
                                                         npx * sweep_ops_per_pixel(c, k, True))
                rec["sweep_energy" + sfx]["bound"] = bound(npx * sweep_bytes(c, False, pb),
                                                           npx * sweep_ops_per_pixel(c, k, False))
            rec["bilinear_sample"]["bound"] = bound(4 * npx * (4 + 2 + 4), npx * sample_ops_per_pixel(4))
            rec["bilinear_sample"]["library_ms"] = grid_sample_ms(stacked[None], p_co[None])
            lib_call = cuda_ms(grid_sample_call(stacked[None], p_co[None]))
            for name in ("halfway_warp", "bilinear_sample", "sweep_grad", "sweep_energy", "halfway_warp_bf16",
                         "sweep_grad_bf16", "sweep_energy_bf16"):
                b_ms, b_by = rec[name]["bound"]
                log(f"  {name} 1024x1024 bound: {b_ms:.4f} ms ({b_by})"
                    + (f"; F.grid_sample {rec[name]['library_ms']:.4f} ms (device), {lib_call:.4f} ms (call)"
                       if rec[name]["library_ms"] else ""))
    # the bf16 forms' word staging on widths of every residue mod 4 and an
    # odd h w; the energy strip's walks against the edges of small frames,
    # both forms
    for (h, w), wins, forms in ([(hw, BF16_PARITY_WINDOWS, ("bf16",)) for hw in BF16_PARITY_HW]
                                + [(hw, ENERGY_STRIP_WINDOWS, ("", "bf16")) for hw in ENERGY_STRIP_HW]):
        rng = np.random.default_rng(h + w)
        i0 = t(rng.random((h, w, 3), dtype=np.float32))
        i1 = t(rng.random((h, w, 3), dtype=np.float32))
        v_lin = t(smooth_field(h, w, 20.0, 1))
        v = t(smooth_field(h, w, 20.0, 1) + smooth_field(h, w, 0.5, 2))
        data = make_level_data(
            i0, i1,
            t(rng.random((h, w, 1), dtype=np.float32)),
            v + t(0.1 * rng.standard_normal((h, w, 2)).astype(np.float32)),
            t(rng.random((h, w, 1), dtype=np.float32)),
            v + t(0.5 * rng.standard_normal((h, w, 2)).astype(np.float32)),
        )
        vq = v_lin.to(BF16).float()
        inputs = {"": (kw.halfway_warp(i0, i1, v_lin), v_lin, data),
                  "bf16": (kw.halfway_warp(i0, i1, vq, BF16), vq, ks.pack_maps(data, BF16))}
        for form in forms:
            planes_f, vl_f, data_f = inputs[form]
            for win in wins:
                check_sweeps(planes_f, vl_f, v, data_f, windows[win], f"{h}x{w} window {win} {form}".rstrip())
    check_sampler_forms(dev, compare, rec, t)
    check_shard_forms(dev, compare, rec, t, p)
    return rec


def sweep_record(name: str, p) -> str:
    """The record of a launch of sweep wrapper ``name`` (float32 form) at
    ``p``'s window: ``<name>_wide`` where the window runs the wide strip."""
    from videomorphing_tpu_torch.kernels import sweep as ks

    wide = ks.wide_strip(name.startswith("sweep_grad"), ks.kernel_radius(p))
    return wide_name(name) if wide else name


def record_wide(rec: dict, window: int, timed: dict) -> None:
    """At ``WIDE_RECORD_WINDOW`` the wide strip's records take the times
    and bound that ``time_wide_window`` measured (``timed``, by form)."""
    if window != WIDE_RECORD_WINDOW:
        return
    for name, (ms, plain_ms, bnd) in timed.items():
        r = rec.setdefault(wide_name(name), {"max_abs_err": 0.0, "max_rel_err": 0.0, "library_ms": None})
        r["ms"], r["plain_ms"], r["bound"] = ms, plain_ms, bnd


def time_wide_window(h: int, w: int, pw, grad, grad_plain, energy, energy_plain, rows: int = 0,
                     shard: bool = False, plane_bytes: int = 4) -> dict:
    """Kernels 1 and 2 (or their shard forms, ``shard``) at one of
    ``WIDE_WINDOWS`` on an h x w whole frame or on a row block of ``rows`` owned
    rows, in float32 or (``plane_bytes`` 2) the bf16 form: device time
    (``graph_ms``, twice), call time, the plain version's call time and the
    bound, logged (the kernels' result line keeps the default window's, the
    wide strip's records ``WIDE_RECORD_WINDOW``'s: ``record_wide``).
    Returns {form: (device ms, plain ms, bound)}."""
    c, k, pb = 3, int(pw.ssim_window), plane_bytes
    own = rows or h
    timed = {}
    for name, kern, plain, with_grad in (("sweep_grad", grad, grad_plain, True),
                                         ("sweep_energy", energy, energy_plain, False)):
        name = name + ("_shard" if shard else "") + ("_bf16" if pb == 2 else "")
        if shard:  # the extended block's planes, v and v_lin; the owned rows' maps and outputs
            nbytes = h * w * (pb * 6 * c + 16) + own * w * (pb * 6 + (16 if with_grad else 0))
        else:
            nbytes = h * w * sweep_bytes(c, with_grad, pb)
        b_ms, b_by = bound(nbytes, own * w * sweep_ops_per_pixel(c, k, with_grad))
        ms, plain_ms, (k1, k2, pl1, pl2), call = timed_pair(kern, plain, 10)
        shape = f"{h}x{w}" + (" block" if shard else "")
        log(f"  {name} {shape} window {k} time: kernel {k1:.4f}/{k2:.4f} ms (device), {call:.4f} ms (call), "
            f"plain {pl1:.4f}/{pl2:.4f} ms; bound {b_ms:.4f} ms ({b_by}), share {b_ms / ms:.0%}")
        timed[name] = (ms, plain_ms, (b_ms, b_by))
    return timed


def timed_pair(kern, plain, reps: int = 20):
    """Kernel and plain version, run plain, kernel, kernel, plain: the
    kernel's device time (``graph_ms``) and the plain version's call time
    (``cuda_ms``); returns (kernel ms, plain ms, the four readings, the
    kernel wrapper's call time)."""
    pl1, k1, k2, pl2 = cuda_ms(plain, reps), graph_ms(kern, reps), graph_ms(kern, reps), cuda_ms(plain, reps)
    call = cuda_ms(kern, reps)
    return float(np.median([k1, k2])), float(np.median([pl1, pl2])), (k1, k2, pl1, pl2), call


def offset_copy(x):
    """A contiguous copy of ``x`` one float into its storage, so its data
    pointer is 4 bytes past a 16-byte boundary (as a view of a stack can be)."""
    import torch

    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    require(out.is_contiguous() and out.data_ptr() % 16 == 4, "offset_copy is not misaligned")
    return out


def check_sampler_variants(dev, compare, t) -> None:
    """Phase 2, kernel 4's instantiations: C = 1..5 on a 540 x 960 image and
    a ragged 135 x 241 one (odd M), single and batched (n = 2), from aligned
    tensors and from misaligned contiguous copies (storage offset of one
    float); the wrapper must pick the vector instantiation exactly when
    ``sample_vectorized`` says so, and every result is bitwise equal to the
    plain version."""
    import torch

    from videomorphing_tpu_torch.kernels import warp as kw

    rng = np.random.default_rng(11)
    for h, w in ((540, 960), (135, 241)):
        gg = t(np.stack(np.mgrid[0:h, 0:w], -1))
        for c in (1, 2, 3, 4, 5):
            imgs = t(rng.random((2, h, w, c), dtype=np.float32))
            coords = torch.stack([gg + t(smooth_field(h, w, 6.0, 20 + k)) for k in range(2)])
            for misaligned in (False, True):
                im, co = (offset_copy(imgs), offset_copy(coords)) if misaligned else (imgs, coords)
                single = kw.sample_vectorized(c, 1, h * w, im[0].data_ptr(), co[0].data_ptr(), 0)
                batched = kw.sample_vectorized(c, 2, h * w, im.data_ptr(), co.data_ptr(), 0)
                expect = c <= 4 and not misaligned
                require(single == expect and batched == (expect and (h * w) % kw.VECTOR_FORMS.get(c, (1,))[0] == 0),
                        f"sample_vectorized C={c} misaligned={misaligned}: {single}, {batched}")
                form = f"{h}x{w}x{c} {'misaligned' if misaligned else 'aligned'}"
                compare("bilinear_sample", kw.bilinear_sample_plain(im[0], co[0]),
                        kw.bilinear_sample(im[0], co[0]), f"{form} ({'vector' if single else 'scalar'})", 0.0, False)
                compare("bilinear_sample_batched", kw.bilinear_sample_batched_plain(im, co),
                        kw.bilinear_sample_batched(im, co), f"2x{form} ({'vector' if batched else 'scalar'})",
                        0.0, False)


def check_sampler_forms(dev, compare, rec, t) -> None:
    """Phase 2, kernel 4 at the video path's shapes: the single form on a
    grey image and at 4 points, the batched form as the flow warps (n = 29
    and the 2(T-1) = 58 of one clip's batch, grey 540 x 960), the occlusion
    round trip (n = 29 two-channel flows at 540 x 960 and at 1080 x 1920)
    and the render (n = 2 four-channel 1080 x 1920 frames) call it, and at
    the shapes of the batch tier and the stressor
    (``batch_tier_sampler_cases``), each with kernel and plain times (10
    calls per reading). Bitwise (the lerps round
    as the plain version's separate operations). The flow warps' 58-image
    case gives the batched form's record; it and the render's case are also
    timed through ``F.grid_sample``. Then the instantiations
    (``check_sampler_variants``)."""
    import torch

    from videomorphing_tpu_torch.kernels import warp as kw

    rng = np.random.default_rng(5)
    h, w = 540, 960
    grey = t(255.0 * rng.random((h, w), dtype=np.float32))
    co = (t(np.stack(np.mgrid[0:h, 0:w], -1)) + t(smooth_field(h, w, 3.0, 3))).contiguous()
    flow = t(smooth_field(1080, 1920, 4.0, 4))
    pts = t(np.stack([rng.uniform(-3, 1083, 4), rng.uniform(-3, 1923, 4)], -1))
    cases = [("bilinear_sample", "540x960 grey", grey, co), ("bilinear_sample", "4 points on 1080x1920x2", flow, pts)]
    for n, (hh, ww), c in ((29, (h, w), 1), (58, (h, w), 1), (29, (h, w), 2), (29, (1080, 1920), 2),
                           (2, (1080, 1920), 4)):
        gg = t(np.stack(np.mgrid[0:hh, 0:ww], -1))
        imgs = torch.stack([t(255.0 * rng.random((hh, ww, c), dtype=np.float32)) for _ in range(n)])
        coords = torch.stack([gg + t(smooth_field(hh, ww, 3.0, 10 + k)) for k in range(n)])
        cases.append(("bilinear_sample_batched", f"{n}x{hh}x{ww}x{c}", imgs, coords))
    cases += batch_tier_sampler_cases(rng, t)
    for name, shape, img, coords in cases:
        kern = getattr(kw, name)
        plain = getattr(kw, name + "_plain")
        compare(name, plain(img, coords), kern(img, coords), shape, 0.0, False)
        ms, plain_ms, (k1, k2, pl1, pl2), call = timed_pair(lambda: kern(img, coords), lambda: plain(img, coords), 10)
        c = 1 if img.dim() == 2 else img.shape[-1]  # a grey (H, W) image has one channel
        npx = coords.numel() // 2
        bnd = bound(4 * (img.numel() + coords.numel() + npx * c), npx * sample_ops_per_pixel(c))
        log(f"  {name} {shape} time: kernel {k1:.4f}/{k2:.4f} ms (device), {call:.4f} ms (call), "
            f"plain {pl1:.4f}/{pl2:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]})")
        if shape in (f"58x{h}x{w}x1", "2x1080x1920x4"):
            lib_ms = grid_sample_ms(img, coords)
            lib_call = cuda_ms(grid_sample_call(img, coords), 10)
            log(f"  {name} {shape} F.grid_sample {lib_ms:.4f} ms (device), {lib_call:.4f} ms (call)")
            if shape == f"58x{h}x{w}x1":
                rec[name]["ms"], rec[name]["plain_ms"] = ms, plain_ms
                rec[name]["bound"], rec[name]["library_ms"] = bnd, lib_ms
    del cases
    torch.cuda.empty_cache()
    check_sampler_variants(dev, compare, t)


def batch_tier_sampler_cases(rng, t) -> list:
    """Kernel 4's inputs on the paths of phases 12-14, at ``MANIFEST_HW``
    and ``STRESSOR_FULL_THW``: the path inversion of a 4K render (the
    fixed point on 2-channel displacements at a quarter and a half of the
    frame, then the stacked 4-channel [d_t, v] sample at full size, single
    form), the render's two colour samples (batched, n = 2, C = 3); the
    stressor's flow warps (n = 2(T-1) grey images at the flow's working
    size, ``flow_scale`` of the frame, passed as ``video.flow._warp_gray``
    passes them: permuted views of an (h, w, n) stack), its occlusion round
    trip (n = T-1 two-channel flows) and its render with the confidences
    as a 4th channel (n = 2, C = 4). Coordinates are the pixel grid plus a
    smooth field that leaves the frame near its borders."""
    import torch

    from videomorphing_tpu_torch.config import VideoParams

    half = lambda n: -(-n // 2)
    grid = lambda hh, ww: t(np.stack(np.mgrid[0:hh, 0:ww], -1))
    coords = lambda hh, ww, n, seed: torch.stack(
        [grid(hh, ww) + t(smooth_field(hh, ww, 8.0, seed + k)) for k in range(n)])
    cases = []
    mh, mw = MANIFEST_HW
    for hh, ww, c, what in ((half(half(mh)), half(half(mw)), 2, "quarter"), (half(mh), half(mw), 2, "half"),
                            (mh, mw, 4, "stacked")):
        img = t(8.0 * rng.standard_normal((hh, ww, c), dtype=np.float32))
        cases.append(("bilinear_sample", f"path inversion ({what}) {hh}x{ww}x{c}", img, coords(hh, ww, 1, 40)[0]))
    imgs = t(rng.random((2, mh, mw, 3), dtype=np.float32))
    cases.append(("bilinear_sample_batched", f"render 2x{mh}x{mw}x3", imgs, coords(mh, mw, 2, 50)))
    t_len, sh, sw = STRESSOR_FULL_THW
    vp = VideoParams()
    fh, fw = max(int(round(sh * vp.flow_scale)), 16), max(int(round(sw * vp.flow_scale)), 16)
    n = 2 * (t_len - 1)
    grey = t(255.0 * rng.random((fh, fw, n), dtype=np.float32))
    flow_coords = coords(fh, fw, n, 60).permute(1, 2, 0, 3).contiguous()
    cases.append(("bilinear_sample_batched", f"stressor flow warps {n}x{fh}x{fw}x1 (views)",
                  grey.permute(2, 0, 1)[..., None], flow_coords.permute(2, 0, 1, 3)))
    for n, c, what in ((t_len - 1, 2, "occlusion"), (2, 4, "render")):
        imgs = t(4.0 * rng.standard_normal((n, sh, sw, c), dtype=np.float32))
        cases.append(("bilinear_sample_batched", f"stressor {what} {n}x{sh}x{sw}x{c}", imgs,
                      coords(sh, sw, n, 70)))
    return cases


def _blocks(h: int, n: int, halo: int):
    """(k, row0, rows) of n row blocks of h rows extended by ``halo``."""
    bh = h // n
    return [(k, k * bh - halo, slice(k * bh, (k + 1) * bh)) for k in range(n)]


def _ext(a, row0: int, rows: int):
    """Rows [row0, row0 + rows) of ``a`` (H, ...), zero rows beyond it (the
    halo exchange's contract)."""
    out = a.new_zeros((rows,) + tuple(a.shape[1:]))
    lo, hi = max(row0, 0), min(row0 + rows, a.shape[0])
    out[lo - row0:hi - row0] = a[lo:hi]
    return out


def check_shard_forms(dev, compare, rec, t, p_default) -> None:
    """Phase 2, the row-shard forms, on row blocks with real halos (2R + 2
    rows): 4 blocks of a 2160 x 3840, C = 3 level, at the default window and
    at ``WIDE_WINDOWS``; ``PAIRS_ROWS_BLOCKS`` blocks of a ``PAIRS_ROWS_HW``
    level (phase 16's block shape); and 4 blocks of a ragged 132 x 241 one
    at every window of ``WINDOW_SIGMA``; the bf16 form (planes and maps in
    bf16, v_lin rounded to bf16) on the two 4K splits at the default window,
    on the 4-block 4K split at ``WIDE_BF16_SHARD_WINDOWS``,
    on the ragged split at every window and on ``BF16_PARITY_SHARD_HW``'s
    splits at ``BF16_PARITY_WINDOWS`` (with the whole-frame checks), and
    those splits in both forms at ``ENERGY_STRIP_SHARD_WINDOWS``. Each
    block's row-offset warp, (partials, grad, precond) and energy partials
    against their plain versions on the same inputs (the warp 1e-6
    absolute, in bf16 one bf16 step of max|ref|; grad and precond kernel
    1's gate, 1e-5 of max|ref|; each raw partial 1e-5 of its own size). At
    the 4K splits and ``BF16_PARITY_SHARD_HW``'s also: the row-offset warp
    equals the whole-frame warp's rows bitwise (zero planes outside the
    frame; in bf16 also the float32 row-offset warp cast), each block's
    grad and precond equal the whole-frame kernel's rows (bitwise required
    in bf16, expected in float32, else within 1e-6 of max|ref|), and the
    shard-summed energies are within 1e-6 relative of
    the whole-frame energy. Then the times, bounds and plain times of the
    forms at the 4-block 4K block shape (at the wide windows logged
    only)."""
    import torch

    from videomorphing_tpu_torch.kernels import sweep as ks
    from videomorphing_tpu_torch.kernels import warp as kw
    from videomorphing_tpu_torch.parallel.spatial import exchange_halo
    from videomorphing_tpu_torch.solver.energy import LevelData, make_level_data

    def compare_parts(name, ref, got, blk):
        """Each raw partial (sim, tps, ui, tc) within 1e-5 of its own size."""
        for i, part in enumerate(("sim", "tps", "ui", "tc")):
            compare(name, ref[i:i + 1], got[i:i + 1], f"{blk} {part} partial", 1e-5, True)

    from videomorphing_tpu_torch.config import MorphParams

    F32, BF16 = torch.float32, torch.bfloat16
    # (shape, params, blocks, whole-frame checks, timed, dtype): the 4K split
    # also at the wide windows, the ragged split at every window
    at = lambda k: p_default if k == p_default.ssim_window else MorphParams(ssim_window=k, ssim_sigma=WINDOW_SIGMA[k])
    cases = ([(SHARD_SHAPES[0], p_default, 4, True, True, F32),
              (PAIRS_ROWS_HW, p_default, PAIRS_ROWS_BLOCKS, True, False, F32)]
             + [(SHARD_SHAPES[0], at(k), 4, True, True, F32) for k in WIDE_WINDOWS]
             + [(SHARD_SHAPES[1], at(k), 4, False, False, F32) for k in WINDOW_SIGMA]
             + [(SHARD_SHAPES[0], p_default, 4, True, True, BF16),
                (PAIRS_ROWS_HW, p_default, PAIRS_ROWS_BLOCKS, True, False, BF16)]
             + [(SHARD_SHAPES[0], at(k), 4, True, True, BF16) for k in WIDE_BF16_SHARD_WINDOWS]
             + [(SHARD_SHAPES[1], at(k), 4, False, False, BF16) for k in WINDOW_SIGMA]
             + [(hw, at(k), 4, True, False, BF16) for hw in BF16_PARITY_SHARD_HW for k in BF16_PARITY_WINDOWS]
             + [(hw, at(k), 4, True, False, dt) for dt in (F32, BF16) for hw in BF16_PARITY_SHARD_HW
                for k in ENERGY_STRIP_SHARD_WINDOWS if not (dt == BF16 and k in BF16_PARITY_WINDOWS)])
    for (h, w), p, n, big, timed, dt in cases:
        halo = exchange_halo(p)
        rng = np.random.default_rng(h + w + 1)
        i0 = t(rng.random((h, w, 3), dtype=np.float32))
        i1 = t(rng.random((h, w, 3), dtype=np.float32))
        v_lin = t(smooth_field(h, w, 20.0, 5))
        v = v_lin + t(smooth_field(h, w, 0.5, 6))
        data = make_level_data(
            i0, i1, t(rng.random((h, w, 1), dtype=np.float32)),
            v + t(0.1 * rng.standard_normal((h, w, 2)).astype(np.float32)),
            t(rng.random((h, w, 1), dtype=np.float32)),
            v + t(0.5 * rng.standard_normal((h, w, 2)).astype(np.float32)),
        )
        bf16 = dt == BF16
        sfx = "_bf16" if bf16 else ""
        grad_name, energy_name = (sweep_record(n, p) + sfx for n in ("sweep_grad_shard", "sweep_energy_shard"))
        if bf16:
            v_lin = v_lin.to(BF16).float()
            data = ks.pack_maps(data, BF16)
        shape = f"{h}x{w} / {n}, window {p.ssim_window}" + (" bf16" if bf16 else "")
        if big:
            planes = kw.halfway_warp(i0, i1, v_lin, dt)
            e_whole, g_whole, p_whole = ks.sweep_grad(planes, v_lin, v, data, p)
            e2_whole = ks.sweep_energy(planes, v_lin, v, data, p)
        parts_g, parts_e, bitwise = [], [], True
        for k, row0, rows in _blocks(h, n, halo):
            he = rows.stop - rows.start + 2 * halo
            vl_e, v_e = _ext(v_lin, row0, he), _ext(v, row0, he)
            data_k = LevelData(i0, i1, *(m[rows].contiguous() for m in (data.ui_w, data.ui_v, data.tc_w, data.tc_v)))
            pl_k = kw.halfway_warp_rows(i0, i1, vl_e, row0, dt)
            pk, gk, pck = ks.sweep_grad_shard(pl_k, vl_e, v_e, data_k, p, row0, h, halo)
            pe = ks.sweep_energy_shard(pl_k, vl_e, v_e, data_k, p, row0, h, halo)
            blk = f"block {k} of {shape}"
            compare("halfway_warp_rows" + sfx, kw.halfway_warp_rows_plain(i0, i1, vl_e, row0, dt).float(),
                    pl_k.float(), blk, 2.0 ** -8 if bf16 else 1e-6, bf16)
            rp, rg, rpc = ks.sweep_grad_shard_plain(pl_k, vl_e, v_e, data_k, p, row0, h, halo)
            compare_parts(grad_name, rp, pk, blk)
            compare(grad_name, rg, gk, blk + " grad", 1e-5, True)
            compare(grad_name, rpc, pck, blk + " precond", 1e-5, True)
            compare_parts(energy_name, ks.sweep_energy_shard_plain(pl_k, vl_e, v_e, data_k, p, row0, h, halo), pe, blk)
            require(torch.equal(ks.sweep_energy_shard(pl_k, vl_e, v_e, data_k, p, row0, h, halo), pe),
                    f"{blk}: sweep_energy_shard rerun is not bitwise identical")
            del rp, rg, rpc
            if big:
                lo, hi = max(row0, 0), min(row0 + he, h)
                require(torch.equal(pl_k[:, lo - row0:hi - row0], planes[:, lo:hi]),
                        f"halfway_warp_rows block {k}: rows differ from the whole-frame warp")
                if bf16:
                    require(torch.equal(pl_k, kw.halfway_warp_rows(i0, i1, vl_e, row0).to(BF16)),
                            f"halfway_warp_rows block {k}: the bf16 output is not the float32 output cast")
                outside = torch.ones(he, dtype=torch.bool, device=dev)
                outside[lo - row0:hi - row0] = False
                require(int(torch.count_nonzero(pl_k[:, outside])) == 0,
                        f"halfway_warp_rows block {k}: non-zero planes outside the frame")
                for name, ref, got in ((grad_name, g_whole[rows], gk), (grad_name, p_whole[rows], pck)):
                    if not torch.equal(ref, got):
                        bitwise = False
                        compare(name, ref, got, f"{blk} vs whole frame", 1e-6, True)
                parts_g.append(pk)
                parts_e.append(pe)
        if not big:
            continue
        # the bf16 staging picks each element's half from its flat index in
        # the block's arrays, whose parities differ from the whole frame's
        require(bitwise or not bf16, f"{shape}: bf16 shard rows differ from the whole frame's")
        log(f"  shard forms on {shape}: row-offset warp rows bitwise equal, zero planes outside; "
            f"grad and precond {'bitwise equal to' if bitwise else 'within 1e-6 of'} the whole frame's rows")
        for name, parts, e_ref in (("sweep_grad_shard", parts_g, e_whole), ("sweep_energy_shard", parts_e, e2_whole)):
            tot = torch.stack(parts).cpu().numpy()
            acc = tot[0].copy()
            for row in tot[1:]:
                acc = acc + row
            e_sh = float(ks.combine_parts(acc, p, h * w, 3))
            rel = abs(e_sh - float(e_ref)) / abs(float(e_ref))
            log(f"  {name + sfx}: shard-summed energy {e_sh:.9g}, whole frame {float(e_ref):.9g}, rel {rel:.3e} "
                "(limit 1e-6)")
            require(rel <= 1e-6, f"{name + sfx}: shard-summed energy off by {rel}")
        del planes, g_whole, p_whole
        if not timed:
            del data, i0, i1
            torch.cuda.empty_cache()
            continue
        # times at block 1's shape (an interior block with both halos)
        k, row0, rows = _blocks(h, n, halo)[1]
        he = rows.stop - rows.start + 2 * halo
        bh = rows.stop - rows.start
        vl_e, v_e = _ext(v_lin, row0, he), _ext(v, row0, he)
        data_k = LevelData(i0, i1, *(m[rows].contiguous() for m in (data.ui_w, data.ui_v, data.tc_w, data.tc_v)))
        pl_k = kw.halfway_warp_rows(i0, i1, vl_e, row0, dt)
        if p is not p_default:
            record_wide(rec, p.ssim_window, time_wide_window(
                he, w, p,
                lambda: ks.sweep_grad_shard(pl_k, vl_e, v_e, data_k, p, row0, h, halo),
                lambda: ks.sweep_grad_shard_plain(pl_k, vl_e, v_e, data_k, p, row0, h, halo),
                lambda: ks.sweep_energy_shard(pl_k, vl_e, v_e, data_k, p, row0, h, halo),
                lambda: ks.sweep_energy_shard_plain(pl_k, vl_e, v_e, data_k, p, row0, h, halo),
                rows=bh, shard=True, plane_bytes=2 if bf16 else 4))
            del pl_k, data, data_k, i0, i1
            torch.cuda.empty_cache()
            continue
        c, kt = 3, int(p.ssim_window)
        pb = 2 if bf16 else 4  # bytes of a plane or map value
        forms = {
            "halfway_warp_rows": (lambda: kw.halfway_warp_rows(i0, i1, vl_e, row0, dt),
                                  lambda: kw.halfway_warp_rows_plain(i0, i1, vl_e, row0, dt),
                                  bound(he * w * (4 * (2 * c + 2) + pb * 6 * c), he * w * warp_ops_per_pixel(c))),
            "sweep_grad_shard": (lambda: ks.sweep_grad_shard(pl_k, vl_e, v_e, data_k, p, row0, h, halo),
                                 lambda: ks.sweep_grad_shard_plain(pl_k, vl_e, v_e, data_k, p, row0, h, halo),
                                 bound(he * w * (pb * 6 * c + 16) + bh * w * (pb * 6 + 16),
                                       bh * w * sweep_ops_per_pixel(c, kt, True))),
            "sweep_energy_shard": (lambda: ks.sweep_energy_shard(pl_k, vl_e, v_e, data_k, p, row0, h, halo),
                                   lambda: ks.sweep_energy_shard_plain(pl_k, vl_e, v_e, data_k, p, row0, h, halo),
                                   bound(he * w * (pb * 6 * c + 16) + bh * w * pb * 6,
                                         bh * w * sweep_ops_per_pixel(c, kt, False))),
        }
        for name, (kern, plain, bnd) in forms.items():
            name += sfx
            rec[name]["ms"], rec[name]["plain_ms"], (k1, k2, pl1, pl2), call = timed_pair(kern, plain, 10)
            rec[name]["bound"] = bnd
            log(f"  {name} {he}x{w} block time: kernel {k1:.4f}/{k2:.4f} ms (device), {call:.4f} ms (call), "
                f"plain {pl1:.4f}/{pl2:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]})")
        del pl_k, data, data_k, i0, i1
        torch.cuda.empty_cache()


def make_pair(n: int):
    """Frame 0 of the JAX bench's synthetic clip pair (a textured base and a
    Gaussian blob that moves from x = 0.45 n to 0.55 n), and its 4 points."""
    from videomorphing_tpu_torch.utils.synthetic import make_clips

    clip_a, clip_b = make_clips(1, n, n, seed=0)
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

    n, n_frames = 1024, 16
    i0, i1, pts = make_pair(n)
    counters = reset_counters()
    t0 = time.perf_counter()
    frames = api.morph_pair(i0, i1, pts, n_frames=n_frames, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters(counters)
    log(f"  launches in the pair path: {launches}")

    require(tuple(frames.shape) == (n_frames, n, n, 3), f"frames have shape {tuple(frames.shape)}")
    require(frames.device.type == "cuda", "frames are not on the card")
    require(bool(torch.isfinite(frames).all()), "non-finite frames")
    require(float(frames.min()) >= 0.0 and float(frames.max()) <= 1.0, "frames leave [0, 1]")
    for name in BASE:
        require(launches[name] > 0, f"kernel {name} was not launched on the main path")
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


def golden(dev) -> dict:
    """Phase 4: ``utils.golden.run_golden`` on the translation, rotation and
    scale cases at ``GOLDEN_HW`` with default parameters: midpoint SSIM
    >= 0.99 for each and a mean field error < 0.1 px for the translation
    (the gate of ``tests/test_golden.py``)."""
    from videomorphing_tpu_torch.utils.golden import run_golden

    h, w = GOLDEN_HW
    counters = reset_counters()
    for case in ("translation", "rotation", "scale"):
        r = run_golden(case, hw=GOLDEN_HW, device=dev)
        log(f"  golden {case} {h}x{w}: ssim_mid {r['ssim_mid']}, v_err_mean {r['v_err_mean']} px, "
            f"v_err_p99 {r['v_err_p99']} px (crop {r['crop']})")
        require(r["ssim_mid"] >= 0.99, f"golden {case}: midpoint SSIM {r['ssim_mid']} < 0.99")
        if case == "translation":
            require(r["v_err_mean"] < 0.1, f"golden translation: mean field error {r['v_err_mean']} >= 0.1 px")
    return read_counters(counters)


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

    from videomorphing_tpu_torch import api
    from videomorphing_tpu_torch.config import VideoParams
    from videomorphing_tpu_torch.utils import profiling
    from videomorphing_tpu_torch.utils.synthetic import make_clips

    t_len, h, w = 30, 1080, 1920
    clip_a, clip_b = make_clips(t_len, h, w, seed=0)
    pts = bench_points(h, w)
    ca = torch.from_numpy(clip_a).to(dev)
    cb = torch.from_numpy(clip_b).to(dev)
    del clip_a, clip_b
    counters = reset_counters()
    t0 = time.perf_counter()
    with profiling.record_phases() as rec:
        res = api.morph_clips(ca, cb, pts, device=dev)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters(counters)
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
    for name in BASE:
        require(launches[name] > 0, f"kernel {name} was not launched on the video path")
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

    from videomorphing_tpu_torch.utils.synthetic import make_clips
    from videomorphing_tpu_torch.video.pipeline import solve_clip_fields

    clip_a, clip_b = make_clips(6, 270, 480, seed=1)
    ca = torch.from_numpy(clip_a).to(dev)
    cb = torch.from_numpy(clip_b).to(dev)
    pts = torch.from_numpy(bench_points(270, 480)).to(dev)
    a = solve_clip_fields(ca, cb, pts)[0]
    b = solve_clip_fields(ca, cb, pts)[0]
    require(torch.equal(a, b), f"reruns differ by {float((a - b).abs().max())} px")
    log(f"  solve_clip_fields 6x270x480 twice: bitwise equal (max |v| {float(a.abs().max()):.3f} px)")


def blob_discs(t_len: int, h: int, w: int, x0: float, dev):
    """Masks (T, H, W) of the bench blob's disc in each frame: radius 3
    sigma (sigma = 0.08 h) around (h / 2, x0 + 2 k) in frame k."""
    import torch

    yy = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :]
    cx = x0 + 2.0 * torch.arange(t_len, device=dev, dtype=torch.float32)[:, None, None]
    return (torch.hypot(yy - 0.5 * h, xx - cx) < 3.0 * 0.08 * h).to(torch.float32)


def kernel_counters():
    """Every kernel's launch counter as (name, wrapper, attribute), in
    ``KERNELS`` order: a bf16 form's is ``launches_bf16`` of its wrapper,
    the wide strip's ``launches_wide`` (``launches_wide_bf16``)."""
    from videomorphing_tpu_torch.kernels import flow as kf
    from videomorphing_tpu_torch.kernels import sweep as ks
    from videomorphing_tpu_torch.kernels import warp as kw

    out = []
    for name in KERNELS:
        base = name.removesuffix("_bf16")
        wide = base.endswith("_wide")
        base = base.removesuffix("_wide")
        fn = getattr(ks, base, None) or getattr(kw, base, None) or getattr(kf, base)
        out.append((name, fn, "launches" + ("_wide" if wide else "") + ("_bf16" if name.endswith("_bf16") else "")))
    return tuple(out)


def check_frames(frames, shape) -> None:
    import torch

    require(tuple(frames.shape) == shape, f"frames have shape {tuple(frames.shape)}")
    require(frames.device.type == "cuda", "frames are not on the card")
    require(bool(torch.isfinite(frames).all()), "non-finite frames")
    require(float(frames.min()) >= 0.0 and float(frames.max()) <= 1.0, "frames leave [0, 1]")


def layered_pair_path(dev, card: str) -> dict:
    """Phase 7: ``api.morph_pair_layered`` on the pair_1k inputs with one
    layer, the blob's disc in each image, 16 frames, default parameters."""
    import torch

    from videomorphing_tpu_torch import api

    n, n_frames = 1024, 16
    i0, i1, pts = make_pair(n)
    layer = dict(mask0=blob_discs(1, n, n, 0.45 * n, dev)[0], mask1=blob_discs(1, n, n, 0.55 * n, dev)[0])
    counters = reset_counters()
    t0 = time.perf_counter()
    frames = api.morph_pair_layered(i0, i1, [layer], pts, n_frames=n_frames, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters(counters)
    log(f"  launches in the layered pair path: {launches}")
    check_frames(frames, (n_frames, n, n, 3))
    for name in BASE:
        require(launches[name] > 0, f"kernel {name} was not launched on the layered pair path")
    cx = blob_centroids_x(frames)
    ca, cb = blob_centroids_x(torch.from_numpy(np.stack([i0, i1])).to(dev))
    log(f"  blob centroid x per frame: {np.round(cx, 2).tolist()} (A {ca:.2f}, B {cb:.2f})")
    require(np.all(np.diff(cx) > 0.0), "blob centroid does not rise monotonically")
    require(abs(cx[0] - ca) < 0.01 * n and abs(cx[-1] - cb) < 0.01 * n, "blob centroid misses A or B")
    sl = (slice(2, -2), slice(2, -2))
    e0 = float((frames[0][sl] - torch.from_numpy(i0).to(dev)[sl]).abs().mean())
    e1 = float((frames[-1][sl] - torch.from_numpy(i1).to(dev)[sl]).abs().mean())
    log(f"  endpoints: mean |frame 0 - A| {e0:.5f}, mean |frame {n_frames - 1} - B| {e1:.5f} (limit 0.02)")
    require(e0 < 0.02 and e1 < 0.02, "the endpoint frames do not reproduce the inputs")
    log(f"  layered pair_1k: wall {wall:.3f} s for 2 solves + {n_frames} frames, "
        f"{n_frames / wall:.3f} frames/s on {card}")
    return launches


def layered_video_path(dev, card: str) -> dict:
    """Phase 8: ``api.morph_clips_layered`` on the 30-frame 1080 x 1920 clip
    pair with 4 points and one layer whose masks follow the blob."""
    import torch

    from videomorphing_tpu_torch import api
    from videomorphing_tpu_torch.utils import profiling
    from videomorphing_tpu_torch.utils.synthetic import make_clips

    t_len, h, w = 30, 1080, 1920
    clip_a, clip_b = make_clips(t_len, h, w, seed=0)
    ca = torch.from_numpy(clip_a).to(dev)
    cb = torch.from_numpy(clip_b).to(dev)
    del clip_a, clip_b
    layer = dict(mask0=blob_discs(t_len, h, w, 0.45 * w, dev), mask1=blob_discs(t_len, h, w, 0.55 * w, dev))
    counters = reset_counters()
    t0 = time.perf_counter()
    with profiling.record_phases() as rec:
        res = api.morph_clips_layered(ca, cb, [layer], bench_points(h, w), device=dev)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters(counters)
    log(f"  launches in the layered video path: {launches}")
    check_frames(res.frames, (t_len, h, w, 3))
    for f in (res.fields_bg,) + tuple(res.fields_layers):
        require(tuple(f.shape) == (t_len, h, w, 2) and bool(torch.isfinite(f).all()), "bad fields")
    for name in BASE:
        require(launches[name] > 0, f"kernel {name} was not launched on the layered video path")
    stages = ("flows", "tracking", "cold_solve", "warm_loop", "layer_solve", "bulges", "confidences", "render")
    log("  stage walls (s): " + ", ".join(f"{k} {rec[k]:.3f}" for k in stages)
        + f"; total {wall:.3f} (flows, tracking, cold_solve and warm_loop include the layer's; "
        "layer_solve is the layer's whole solve)")
    log(f"  layered video_1080p: wall {wall:.3f} s for {t_len} frames, {t_len / wall:.3f} frames/s, "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
    cx = np.concatenate([blob_centroids_x(res.frames[k:k + 10]) for k in range(0, t_len, 10)])
    ca0 = blob_centroids_x(ca[:1])[0]
    cb_end = blob_centroids_x(cb[-1:])[0]
    log(f"  blob centroid x per frame: {np.round(cx, 2).tolist()} "
        f"(A[0] {ca0:.2f}, B[{t_len - 1}] {cb_end:.2f})")
    require(np.all(np.diff(cx) > 0.0), "blob centroid does not rise monotonically")
    require(abs(cx[0] - ca0) < 0.01 * w and abs(cx[-1] - cb_end) < 0.01 * w,
            "blob centroid misses clip A's first or clip B's last frame")
    layer_warp_sample(ca, cb, layer, res.fields_layers[0], dev)
    del res, ca, cb, layer
    torch.cuda.empty_cache()
    return launches


def layer_warp_sample(ca, cb, layer, fields, dev) -> None:
    """Kernel 4 at the shape the layer warp gives it, against its plain
    version: both mask-carrying frames (C = 4) of frame 15 at p -/+ v of the
    layer's field, one batched launch; bitwise, with kernel and plain
    times."""
    import torch

    from videomorphing_tpu_torch.kernels import warp as kw
    from videomorphing_tpu_torch.ops.resample import grid_coords

    k = 15
    imgs = torch.stack([torch.cat([ca[k], layer["mask0"][k, ..., None]], -1),
                        torch.cat([cb[k], layer["mask1"][k, ..., None]], -1)])
    g = grid_coords(ca.shape[1], ca.shape[2], device=dev)
    coords = torch.stack([g - fields[k], g + fields[k]])
    ref = kw.bilinear_sample_batched_plain(imgs, coords)
    got = kw.bilinear_sample_batched(imgs, coords)
    err = float((ref.double() - got.double()).abs().max())
    shape = "x".join(map(str, imgs.shape))
    log(f"  bilinear_sample_batched {shape} (the layer warp): max_abs_err={err:.3e} (bitwise required)")
    require(bool(torch.isfinite(got).all()) and torch.equal(ref, got), f"bilinear_sample_batched {shape}: err {err}")
    _, _, (k1, k2, pl1, pl2), call = timed_pair(lambda: kw.bilinear_sample_batched(imgs, coords),
                                                lambda: kw.bilinear_sample_batched_plain(imgs, coords), 10)
    log(f"  bilinear_sample_batched {shape} time: kernel {k1:.4f}/{k2:.4f} ms (device), {call:.4f} ms (call), "
        f"plain {pl1:.4f}/{pl2:.4f} ms")


def spatial_path(dev, card: str) -> dict:
    """Phase 10: the 4K pair (frame 0 of the bench's 2160 x 3840 clips, its
    4 points, default parameters) through ``optimize_pair_spatial`` on a
    mesh of 4 row blocks of the card, then 16 frames through
    ``ImageMorpher.render``; then the single-device ``api.solve_pair`` of
    the same pair and one 1080 x 1920 level, 6 iterations, both ways."""
    import torch

    from videomorphing_tpu_torch import api
    from videomorphing_tpu_torch.config import MorphParams, SynthParams
    from videomorphing_tpu_torch.models.image_morph import ImageMorpher, MorphArtifacts
    from videomorphing_tpu_torch.ops.pyramid import gaussian_pyramid, pyramid_shapes
    from videomorphing_tpu_torch.parallel.mesh import make_mesh
    from videomorphing_tpu_torch.parallel.spatial import (
        level_is_sharded,
        make_spatial_level_solver,
        optimize_pair_spatial,
    )
    from videomorphing_tpu_torch.solver.constraints import rasterize_point_constraints, scale_points
    from videomorphing_tpu_torch.solver.descent import make_level_solver
    from videomorphing_tpu_torch.solver.energy import make_level_data
    from videomorphing_tpu_torch.synth.paths import bulge_field
    from videomorphing_tpu_torch.utils.synthetic import make_clips
    from videomorphing_tpu_torch.video.pipeline import _default_times

    (h, w), n_frames, n_blocks = SPATIAL_HW, 16, 4
    clip_a, clip_b = make_clips(1, h, w, seed=0)
    i0 = torch.from_numpy(clip_a[0]).to(dev)
    i1 = torch.from_numpy(clip_b[0]).to(dev)
    del clip_a, clip_b
    pts = bench_points(h, w)
    mp = MorphParams()
    mesh = make_mesh((n_blocks,), ("y",), devices=[dev] * n_blocks)

    def single_solve():
        t0 = time.perf_counter()
        art = api.solve_pair(i0, i1, pts, mp, device=dev)
        torch.cuda.synchronize()
        return art, time.perf_counter() - t0

    # the single-device solve of the same pair before and after the sharded
    # one, so that neither side carries the first use of the 4K shapes alone
    single, t_single0 = single_solve()
    counters = reset_counters()
    t0 = time.perf_counter()
    res = optimize_pair_spatial(i0, i1, pts, mp, mesh)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    art = MorphArtifacts(v=res.v, b=bulge_field(res.v, SynthParams()), result=res)
    frames = ImageMorpher(mp, device=str(dev)).render(i0, i1, art, _default_times(n_frames, "cpu"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters(counters)
    log(f"  launches in the spatial path: {launches}")
    check_frames(frames, (n_frames, h, w, 3))
    for name in ("sweep_grad_shard", "sweep_energy_shard", "halfway_warp_rows") + BASE:
        require(launches[name] > 0, f"kernel {name} was not launched on the spatial path")
    shapes = pyramid_shapes(h, w, res.n_levels)
    for li, s in enumerate(res.level_stats):
        lh, lw = shapes[res.n_levels - 1 - li]
        kind = "sharded" if level_is_sharded(lh, n_blocks, mp) else "local"
        log(f"  level {lh}x{lw} {kind}: iters={s.iters} e0={s.e0:.6f} e_final={s.e_final:.6f}")
        require(s.e_final < s.e0, f"level {lh}x{lw}: energy did not decrease")
    cx = blob_centroids_x(frames)
    ca, cb = blob_centroids_x(torch.stack([i0, i1]))
    log(f"  blob centroid x per frame: {np.round(cx, 2).tolist()} (A {ca:.2f}, B {cb:.2f})")
    require(np.all(np.diff(cx) > 0.0), "blob centroid does not rise monotonically")
    require(abs(cx[0] - ca) < 0.01 * w and abs(cx[-1] - cb) < 0.01 * w, "blob centroid misses A or B")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  spatial_4k: wall {wall:.3f} s (solve {t_solve:.3f} s + {n_frames} frames), "
        f"peak device memory {peak:.2f} GiB, {n_blocks} row blocks on one card (in turn) on {card}")
    del frames
    torch.cuda.empty_cache()

    single2, t_single = single_solve()
    require(torch.equal(single.v, single2.v), "the single-device 4K solve is not bitwise repeatable")
    dv = (single.v - res.v).abs().flatten().sort().values
    at = lambda q: float(dv[int(q * (dv.numel() - 1))])
    log(f"  single-device api.solve_pair of the same pair: {t_single0:.3f} s before, {t_single:.3f} s after "
        f"the sharded solve ({t_solve:.3f} s); |dv| against the sharded solve p50 {at(0.5):.3e}, "
        f"p99 {at(0.99):.3e}, max {at(1.0):.3e} px")

    # one 1080 x 1920 level, 6 iterations, from zero: sharded vs single device
    pyr0 = gaussian_pyramid(i0, 2)
    pyr1 = gaussian_pyramid(i1, 2)
    lh, lw = pyr0[1].shape[0], pyr0[1].shape[1]
    lpts = scale_points(torch.from_numpy(pts).to(dev), (h, w), (lh, lw))
    ui_w, ui_v = rasterize_point_constraints(lpts, (lh, lw), mp.ui_sigma, torch.float32, dev)
    data = make_level_data(pyr0[1], pyr1[1], ui_w, ui_v)
    v0 = torch.zeros((lh, lw, 2), device=dev)
    v_ref, st_ref = make_level_solver(mp, 6)(v0, data)
    v_sh, st_sh = make_spatial_level_solver(mp, 6, mesh)(v0, data)
    err = float((v_ref - v_sh).abs().max())
    e0_rel = abs(st_sh.e0 - st_ref.e0) / abs(st_ref.e0)
    ef_rel = abs(st_sh.e_final - st_ref.e_final) / abs(st_ref.e_final)
    log(f"  {lh}x{lw} level, 6 iterations: sharded vs single device max |dv| {err:.3e} (limit 2e-3), "
        f"e0 rel {e0_rel:.3e} (limit 1e-5), e_final rel {ef_rel:.3e}; iters {st_sh.iters}/{st_ref.iters}")
    require(err <= 2e-3 and e0_rel <= 1e-5, "the sharded 1080p level disagrees with the single-device solve")
    del pyr0, pyr1, data, single, single2, res, i0, i1
    torch.cuda.empty_cache()
    return launches


def mesh_video_path(dev, card: str) -> dict:
    """Phase 11: ``api.morph_clips`` on phase 5's clip pair and points with
    a 3-device mesh of the card (blocks of 10 frames); the sharded flows
    against ``clip_flows`` (1e-5) and the mesh render against the
    sequential render of the same fields and flows (2e-5)."""
    import torch

    from videomorphing_tpu_torch import api
    from videomorphing_tpu_torch.config import VideoParams
    from videomorphing_tpu_torch.parallel.mesh import make_mesh
    from videomorphing_tpu_torch.utils import profiling
    from videomorphing_tpu_torch.utils.synthetic import make_clips
    from videomorphing_tpu_torch.video.flow import clip_flows, clip_flows_sharded
    from videomorphing_tpu_torch.video.pipeline import render_video

    t_len, h, w = MESH_VIDEO_THW
    clip_a, clip_b = make_clips(t_len, h, w, seed=0)
    ca = torch.from_numpy(clip_a).to(dev)
    cb = torch.from_numpy(clip_b).to(dev)
    del clip_a, clip_b
    mesh = make_mesh((3,), devices=[dev] * 3)
    counters = reset_counters()
    t0 = time.perf_counter()
    with profiling.record_phases() as rec:
        res = api.morph_clips(ca, cb, bench_points(h, w), mesh=mesh, device=dev)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters(counters)
    log(f"  launches in the mesh video path: {launches}")
    check_frames(res.frames, (t_len, h, w, 3))
    require(bool(torch.isfinite(res.fields).all()), "non-finite fields")
    for name in BASE:
        require(launches[name] > 0, f"kernel {name} was not launched on the mesh video path")
    warm = rec["warm_iters"]
    fine = VideoParams().warm_iters_fine
    require(len(warm) == t_len - 3 and all(1 <= k <= fine for k in warm),
            f"warm frames ran outside [1, {fine}] iterations: {warm}")
    stages = ("flows", "tracking", "cold_solve", "warm_loop", "bulges", "confidences", "render")
    log("  stage walls (s): " + ", ".join(f"{k} {rec[k]:.3f}" for k in stages)
        + f"; total {wall:.3f}; 3 cold heads, warm iterations {warm}")
    log(f"  mesh video_1080p: wall {wall:.3f} s for {t_len} frames, {t_len / wall:.3f} frames/s, "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, 3 blocks on one card "
        f"(in turn) on {card}")
    cx = np.concatenate([blob_centroids_x(res.frames[k:k + 10]) for k in range(0, t_len, 10)])
    ca0 = blob_centroids_x(ca[:1])[0]
    cb_end = blob_centroids_x(cb[-1:])[0]
    log(f"  blob centroid x per frame: {np.round(cx, 2).tolist()} (A[0] {ca0:.2f}, B[{t_len - 1}] {cb_end:.2f})")
    require(np.all(np.diff(cx) > 0.0), "blob centroid does not rise monotonically")

    vp = VideoParams()
    flows = {}
    for name, clip in (("fa", ca), ("fb", cb)):
        f_seq, b_seq = clip_flows(clip, vp)
        f_sh, b_sh = clip_flows_sharded(clip, vp, mesh)
        err = max(float((f_seq - f_sh).abs().max()), float((b_seq - b_sh).abs().max()))
        log(f"  clip_flows_sharded {name}: max |d| against clip_flows {err:.3e} px (limit 1e-5)")
        require(err <= 1e-5, f"sharded flows of clip {name} differ by {err}")
        flows[name + "_fwd"], flows[name + "_bwd"] = f_sh, b_sh
        del f_seq, b_seq
    seq = render_video(ca, cb, res.fields, flows=flows)
    err = float((seq.frames - res.frames).abs().max())
    log(f"  mesh render against the sequential render of the same fields: max |d| {err:.3e} (limit 2e-5)")
    require(err <= 2e-5, f"the mesh render differs by {err}")
    del res, seq, ca, cb, flows
    torch.cuda.empty_cache()
    return launches


def run_cli(args):
    """``python -m videomorphing_tpu_torch.cli <args>`` in a child process
    from the checkout's root; returns its JSON lines (from ``-v``)."""
    cmd = [sys.executable, "-m", "videomorphing_tpu_torch.cli", *args]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    require(out.returncode == 0, f"cli {args[0]} exited {out.returncode}:\n{out.stdout}\n{out.stderr[-4000:]}")
    log(f"  cli {args[0]} ({wall:.2f} s with process start): {out.stdout.strip().splitlines()[-1]}")
    return [json.loads(line) for line in out.stderr.splitlines() if line.startswith("{")]


def command_line() -> None:
    """Phase 9: the command line on a 6-frame 270 x 480 clip pair as .vmc
    files (no PIL needed): ``video`` with a field store, again to resume
    from it, and ``project`` on a layered clip project."""
    from videomorphing_tpu_torch.io.clips import read_vmc, read_vmc_header, save_clip
    from videomorphing_tpu_torch.utils.synthetic import make_clips

    t_len, h, w = 6, 270, 480
    clip_a, clip_b = make_clips(t_len, h, w, seed=1)
    with tempfile.TemporaryDirectory() as tmp:
        f = lambda name: os.path.join(tmp, name)
        save_clip(f("a.vmc"), clip_a)
        save_clip(f("b.vmc"), clip_b)
        with open(f("p.json"), "w") as fh:
            json.dump({"points": bench_points(h, w).tolist()}, fh)
        args = ["video", f("a.vmc"), f("b.vmc"), "--points", f("p.json"), "--fields", f("store.npz"),
                "-v", "--out", f("out.vmc")]
        events = run_cli(args)
        metrics = [e for e in events if e.get("event") == "metrics"]
        require(len(metrics) == 1, "cli video emitted no metrics line")
        keys = ("ssim_t0_vs_a", "ssim_t1_vs_b", "ssim_halfway_agreement")
        require(all(k in metrics[0] for k in keys), f"metrics lack {keys}: {metrics[0]}")
        log("  cli video metrics: " + json.dumps({k: metrics[0][k] for k in keys + ("frames_per_sec",)}))
        first = Path(f("out.vmc")).read_bytes()
        require(read_vmc_header(f("out.vmc")) == (t_len, h, w, 3), "cli video wrote a wrong shape")
        events = run_cli(args)
        resumed = [e for e in events if e.get("event") == "resume"]
        require(len(resumed) == 1 and resumed[0]["skipped_frames"] == t_len,
                f"the second run did not resume all {t_len} frames: {resumed}")
        require(Path(f("out.vmc")).read_bytes() == first, "the resumed run wrote other frames")
        log(f"  cli video resumed {t_len} stored frames and wrote the same {len(first)} bytes")

        for name, x0 in (("m0.npy", 0.45 * w), ("m1.npy", 0.55 * w)):
            np.save(f(name), blob_discs(t_len, h, w, x0, "cpu").numpy())
        proj = {"source_a": f("a.vmc"), "source_b": f("b.vmc"), "points": bench_points(h, w).tolist(),
                "layers": [{"mask_a": f("m0.npy"), "mask_b": f("m1.npy")}], "output": f("layered.vmc")}
        with open(f("job.json"), "w") as fh:
            json.dump(proj, fh)
        run_cli(["project", f("job.json")])
        frames = read_vmc(f("layered.vmc"))
        require(frames.shape == (t_len, h, w, 3) and np.isfinite(frames).all(),
                f"cli project wrote {frames.shape}")


def sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def reset_counters():
    """Every launch counter set to 0 (after a synchronize), and the peak
    memory statistic reset on a card; returns the counters."""
    import torch

    counters = kernel_counters()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for _, fn, attr in counters:
        setattr(fn, attr, 0)
    return counters


def read_counters(counters) -> dict:
    return {name: getattr(fn, attr) for name, fn, attr in counters}


def peak_gib(dev) -> str:
    import torch

    if torch.device(dev).type != "cuda":
        return "not measured"
    return f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"


def check_endpoints(frames, i0, i1, what: str) -> None:
    """The first and last frames reproduce the inputs: mean |d| < 0.02 off a
    2-pixel border (phase 7's tolerance)."""
    sl = (slice(2, -2), slice(2, -2))
    e0 = float(np.abs(frames[0][sl] - i0[sl]).mean())
    e1 = float(np.abs(frames[-1][sl] - i1[sl]).mean())
    log(f"  {what} endpoints: mean |frame 0 - A| {e0:.5f}, mean |last - B| {e1:.5f} (limit 0.02)")
    require(e0 < 0.02 and e1 < 0.02, f"{what}: the endpoint frames do not reproduce the inputs")


def manifest_path(dev, card: str) -> dict:
    """Phase 12: ``parallel.batch.run_manifest`` on three jobs of frame 0 of
    ``make_clips(1, *MANIFEST_HW, seed=s)``, s = 0, 1, 2 (the bench's 4
    points and 4 frames; no points and 4 frames; points and 2 frames) over
    a 2-device mesh of the card: two blocks, the second of one job (unpadded). Each job's
    frames must equal ``api.morph_pair`` of the job bitwise (the same pair
    path on the same inputs), be finite, hold their count and reproduce
    the inputs at the ends."""
    import torch

    from videomorphing_tpu_torch import api
    from videomorphing_tpu_torch.parallel.batch import run_manifest
    from videomorphing_tpu_torch.parallel.mesh import make_mesh
    from videomorphing_tpu_torch.utils.synthetic import make_clips

    h, w = MANIFEST_HW
    pts = bench_points(h, w)
    jobs = []
    for seed, points, n_frames in ((0, pts, 4), (1, None, 4), (2, pts, 2)):
        clip_a, clip_b = make_clips(1, h, w, seed=seed)
        jobs.append(dict(i0=clip_a[0], i1=clip_b[0], points=points, n_frames=n_frames))
    mesh = make_mesh(devices=[dev] * 2)
    counters = reset_counters()
    t0 = time.perf_counter()
    outs = run_manifest(jobs, mesh, verbose=True)
    wall = time.perf_counter() - t0
    launches = read_counters(counters)
    peak = peak_gib(dev)
    log(f"  launches in the manifest path: {launches}")
    require([o.shape for o in outs] == [(j["n_frames"], h, w, 3) for j in jobs],
            f"manifest frames have shapes {[o.shape for o in outs]}")
    for name in BASE:
        require(launches[name] > 0, f"kernel {name} was not launched on the manifest path")
    log(f"  batch_manifest_4k: wall {wall:.3f} s for {len(jobs)} pairs ({sum(j['n_frames'] for j in jobs)} frames), "
        f"{len(jobs) / wall:.3f} pairs/s, peak device memory {peak}, 2 slots on one card (in turn) on {card}")
    for k, (job, frames) in enumerate(zip(jobs, outs)):
        require(np.isfinite(frames).all(), f"job {k}: non-finite frames")
        ref = api.morph_pair(job["i0"], job["i1"], job["points"], job["n_frames"], device=dev).cpu().numpy()
        err = float(np.abs(ref - frames).max())
        log(f"  job {k}: max |d| against api.morph_pair {err:.3e} (bitwise required)")
        require(np.array_equal(ref, frames), f"job {k}: the manifest frames differ from api.morph_pair by {err}")
        check_endpoints(frames, job["i0"], job["i1"], f"job {k}")
    del outs, jobs
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    return launches


def stream_path(dev, card: str) -> dict:
    """Phase 13: ``make_clips(*STREAM_THW, seed=0)`` written as two ``.vmc``
    stores, streamed through the native reader (required) by
    ``StreamingBatchRunner.run_clip_pair`` over a 2-device mesh of the card
    (reader blocks of 2) into a ``VmcWriter``. Frame k must equal the pair's
    own solve rendered at ``linspace(0, 1, T)[k]`` bitwise, on the same
    decoded frames, and the written store reads back as the frames'
    uint8 quantization."""
    import torch

    from videomorphing_tpu_torch import api
    from videomorphing_tpu_torch.io.clips import VmcWriter, open_clip_reader, read_vmc, save_clip
    from videomorphing_tpu_torch.io.images import to_uint8
    from videomorphing_tpu_torch.models.image_morph import ImageMorpher
    from videomorphing_tpu_torch.parallel.batch import StreamingBatchRunner
    from videomorphing_tpu_torch.parallel.mesh import make_mesh
    from videomorphing_tpu_torch.utils.synthetic import make_clips

    t_len, h, w = STREAM_THW
    with tempfile.TemporaryDirectory() as tmp:
        pa, pb, out = (os.path.join(tmp, n) for n in ("a.vmc", "b.vmc", "out.vmc"))
        clip_a, clip_b = make_clips(t_len, h, w, seed=0)
        save_clip(pa, clip_a)
        save_clip(pb, clip_b)
        del clip_a, clip_b
        mesh = make_mesh(devices=[dev] * 2)
        runner = StreamingBatchRunner(mesh)
        ra, rb = open_clip_reader(pa, block=2), open_clip_reader(pb, block=2)
        require(ra.kind == rb.kind == "native", f"the .vmc readers are {ra.kind!r} / {rb.kind!r}, not native")
        stats, got = [], {}
        counters = reset_counters()
        t0 = time.perf_counter()
        with VmcWriter(out) as wr:
            for s0, frames in runner.run_clip_pair(ra, rb, t_len, (h, w), stats=stats):
                wr.append(frames)
                got[s0] = frames
        wall = time.perf_counter() - t0
        launches = read_counters(counters)
        peak = peak_gib(dev)
        log(f"  launches in the stream path: {launches}")
        for name in BASE:
            require(launches[name] > 0, f"kernel {name} was not launched on the stream path")
        frames = np.concatenate([got[k] for k in sorted(got)])
        require(frames.shape == (t_len, h, w, 3) and np.isfinite(frames).all(),
                f"the stream gave {frames.shape} frames (finite: {np.isfinite(frames).all()})")
        sums = {k: sum(st[k] for st in stats) for k in ("decode_s", "h2d_s", "dispatch_s", "fetch_s")}
        log(f"  batch_stream_4k: wall {wall:.3f} s for {t_len} pairs, {t_len / wall:.3f} pairs/s, "
            f"peak device memory {peak}, 2 slots on one card (in turn) on {card}")
        log("  stats per block: " + json.dumps([{k: (round(v, 4) if isinstance(v, float) else v)
                                                 for k, v in st.items()} for st in stats]))
        log("  stats sums (s): " + ", ".join(f"{k} {v:.4f}" for k, v in sums.items()))
        require(np.array_equal(read_vmc(out), to_uint8(frames) / np.float32(255.0)),
                "the written .vmc does not read back as the frames' quantization")
        ca = np.concatenate([b for _, b in open_clip_reader(pa, block=t_len)])
        cb = np.concatenate([b for _, b in open_clip_reader(pb, block=t_len)])
    times = np.linspace(0.0, 1.0, t_len, dtype=np.float32)
    morpher = ImageMorpher(device=str(dev))
    worst = 0.0
    for k in range(t_len):
        i0, i1 = api._dev(ca[k], dev), api._dev(cb[k], dev)
        ref = morpher.render(i0, i1, morpher.solve(i0, i1), times[k:k + 1])[0].cpu().numpy()
        worst = max(worst, float(np.abs(ref - frames[k]).max()))
        require(np.array_equal(ref, frames[k]), f"stream frame {k} differs from its pair's morph by {worst}")
    log(f"  every frame equals its pair's solve rendered at its time: max |d| {worst:.3e} (bitwise required)")
    check_endpoints(frames, ca[0], cb[-1], "stream")
    del frames, ca, cb, got
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    return launches


def batch_command_line(dev) -> None:
    """Phase 13, the command line: ``cli batch`` in child processes on
    ``make_clips(*CLI_BATCH_THW, seed=1)``: ``--clip-a/--clip-b`` on the
    ``.vmc`` pair with the bench's points, and ``--manifest`` of two jobs
    (``.npy`` frames: frame 0 with the points and 3 frames, frame 3 with
    none and 2 frames). Each must exit 0 and write the bytes that the
    in-process call writes."""
    import torch

    from videomorphing_tpu_torch.io.clips import VmcWriter, open_clip_reader, save_clip
    from videomorphing_tpu_torch.parallel.batch import StreamingBatchRunner, run_manifest
    from videomorphing_tpu_torch.parallel.mesh import make_mesh
    from videomorphing_tpu_torch.utils.synthetic import make_clips

    t_len, h, w = CLI_BATCH_THW
    clip_a, clip_b = make_clips(t_len, h, w, seed=1)
    pts = bench_points(h, w)
    mesh = make_mesh(devices=[dev])  # the CLI's mesh: every card of the machine
    with tempfile.TemporaryDirectory() as tmp:
        f = lambda name: os.path.join(tmp, name)
        save_clip(f("a.vmc"), clip_a)
        save_clip(f("b.vmc"), clip_b)
        with open(f("p.json"), "w") as fh:
            json.dump({"points": pts.tolist()}, fh)
        events = run_cli(["batch", "--clip-a", f("a.vmc"), "--clip-b", f("b.vmc"), "--points", f("p.json"),
                          "--out", f("cli.vmc"), "-v", "--device", torch.device(dev).type])
        require(any(e.get("event") == "metrics" for e in events), "cli batch emitted no metrics line")
        with VmcWriter(f("lib.vmc")) as wr:
            for _s, frames in StreamingBatchRunner(mesh).run_clip_pair(
                    open_clip_reader(f("a.vmc"), block=1), open_clip_reader(f("b.vmc"), block=1),
                    t_len, (h, w), points=pts):
                wr.append(frames)
        require(Path(f("cli.vmc")).read_bytes() == Path(f("lib.vmc")).read_bytes(),
                "cli batch --clip-a/--clip-b wrote other frames than run_clip_pair")
        log(f"  cli batch --clip-a/--clip-b wrote the {Path(f('cli.vmc')).stat().st_size} bytes of run_clip_pair")

        jobs = []
        for k, (points, n_frames) in enumerate(((pts, 3), (None, 2))):
            src = 3 * k
            np.save(f(f"a{k}.npy"), clip_a[src])
            np.save(f(f"b{k}.npy"), clip_b[src])
            jobs.append(dict(a=f(f"a{k}.npy"), b=f(f"b{k}.npy"), n_frames=n_frames, out=f(f"m{k}.vmc"),
                             **({"points": points.tolist()} if points is not None else {})))
        with open(f("jobs.json"), "w") as fh:
            json.dump({"jobs": jobs}, fh)
        events = run_cli(["batch", "--manifest", f("jobs.json"), "-v", "--device", torch.device(dev).type])
        require(any(e.get("event") == "metrics" for e in events), "cli batch --manifest emitted no metrics line")
        lib = run_manifest([dict(i0=clip_a[3 * k], i1=clip_b[3 * k], points=None if j.get("points") is None
                                 else np.asarray(j["points"], np.float32), n_frames=j["n_frames"])
                            for k, j in enumerate(jobs)], mesh)
        for k, frames in enumerate(lib):
            save_clip(f(f"lib{k}.vmc"), frames)
            require(Path(f(f"m{k}.vmc")).read_bytes() == Path(f(f"lib{k}.vmc")).read_bytes(),
                    f"cli batch --manifest job {k} wrote other frames than run_manifest")
        log("  cli batch --manifest wrote the bytes of run_manifest for both jobs")


def stressor_path(dev, card: str) -> dict:
    """Phase 14: ``utils.stressor`` at ``STRESSOR_GATE_THW`` (the size of
    ``tests/test_stressor.py``, seed 3): ``video.pipeline.morph_video`` with
    the robust flow, 4 frames at blend 0.5, must beat the cross-dissolve on
    the analytic mid frames by 0.01 SSIM (that test's claim). Then at
    ``STRESSOR_FULL_THW`` (the module's defaults, seed 0), no gate: clip A's
    robust-flow EPE (mean and p95, background and disk), occlusion F1, and
    the midframe SSIM of the morph and of the dissolve."""
    import torch

    from videomorphing_tpu_torch.config import VideoParams
    from videomorphing_tpu_torch.utils.golden import ssim
    from videomorphing_tpu_torch.utils.stressor import flow_epe, make_stressor, midframe_ssim, occlusion_f1
    from videomorphing_tpu_torch.video.flow import clip_flows
    from videomorphing_tpu_torch.video.occlusion import occlusion_confidence
    from videomorphing_tpu_torch.video.pipeline import morph_video

    vp = VideoParams(flow_robust=True)

    def morph_and_dissolve(case):
        t_len = case.clip_a.shape[0]
        res = morph_video(case.clip_a, case.clip_b, points={0: torch.from_numpy(case.points).to(dev)},
                          times=torch.full((t_len,), 0.5), vp=vp)
        dissolve = 0.5 * (case.clip_a + case.clip_b)
        base = float(np.mean([ssim(dissolve[t], case.mid_true[t], crop=case.crop) for t in range(t_len)]))
        return midframe_ssim(res.frames, case)["ssim_mid_mean"], base

    counters = reset_counters()
    t0 = time.perf_counter()
    t_len, h, w = STRESSOR_GATE_THW
    morph, base = morph_and_dissolve(make_stressor(t_len, h, w, seed=3, device=dev))
    log(f"  stressor {t_len}x{h}x{w}: midframe SSIM morph (robust flow) {morph:.5f}, cross-dissolve {base:.5f} "
        "(morph must exceed dissolve + 0.01)")
    require(morph > base + 0.01, f"the stressor morph ({morph}) does not beat the cross-dissolve ({base})")

    t_len, h, w = STRESSOR_FULL_THW
    case = make_stressor(t_len, h, w, seed=0, device=dev)
    fwd, bwd = clip_flows(case.clip_a, vp)
    bg = case.valid_a & ~case.disk_a
    disk = case.valid_a & case.disk_a
    epe_bg = flow_epe(fwd, case.flow_a_true, bg)
    epe_disk = flow_epe(fwd, case.flow_a_true, disk)
    occ = occlusion_f1(occlusion_confidence(fwd, bwd, vp), case.occ_a)
    morph, base = morph_and_dissolve(case)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = read_counters(counters)
    log(f"  launches in the stressor paths: {launches}")
    log(f"  stressor {t_len}x{h}x{w} (robust flow, clip A): EPE background mean {epe_bg['epe_mean']:.4f} / "
        f"p95 {epe_bg['epe_p95']:.4f} px, disk mean {epe_disk['epe_mean']:.4f} / p95 {epe_disk['epe_p95']:.4f} px; "
        f"occlusion F1 {occ['f1']:.4f} (precision {occ['precision']:.4f}, recall {occ['recall']:.4f}); "
        f"midframe SSIM morph {morph:.5f}, cross-dissolve {base:.5f}; both sizes in {wall:.3f} s on {card}")
    for name in BASE:
        require(launches[name] > 0, f"kernel {name} was not launched on the stressor paths")
    return launches


def cursor_events(n: int, x_a: int, x_b: int) -> list:
    """Cursor-mode events that place a pair from the view's centre: A at
    (n / 2, x_a), B at (n / 2, x_b), then solve and leave (10 px steps,
    then 1 px steps)."""
    def walk(dx):
        big, small = ("RIGHT", "right") if dx > 0 else ("LEFT", "left")
        return [big] * (abs(dx) // 10) + [small] * (abs(dx) % 10)

    return walk(x_a - n // 2) + ["place"] + walk(x_b - x_a) + ["place", "solve", "quit"]


def edit_session(dev, card: str) -> dict:
    """Phase 15: ``edit.PointEditor`` on ``make_pair(EDIT_N)`` with ANSI
    previews of 160 columns, driven command by command: add the 4 bench
    points, solve (cold), move pair 0's B point by 3 px, solve (warm, from
    the middle level), preview t = 0.5, a cursor session that places a
    fifth pair and solves, render 16 frames to an ``.npz``, save. Then an
    ``api.Session`` given the same point edits directly: its field must
    equal the editor's bitwise, and its ``render(16)`` the ``.npz``
    frames; the halfway view must equal the plain sampler's average on the
    same card tensors bitwise."""
    import io

    import torch

    from videomorphing_tpu_torch import api
    from videomorphing_tpu_torch.edit import PointEditor
    from videomorphing_tpu_torch.io.images import to_uint8
    from videomorphing_tpu_torch.kernels import warp as kw
    from videomorphing_tpu_torch.ops.resample import grid_coords
    from videomorphing_tpu_torch.viewer import halfway_image

    n = EDIT_N
    i0, i1, pts = make_pair(n)
    moved = pts.copy()
    moved[0, 1, 1] += np.float32(3.0)
    x_a, x_b = int(round(0.45 * n)), int(round(0.55 * n))
    fifth = np.array([[[n / 2, x_a], [n / 2, x_b]]], np.float32)
    out = io.StringIO()
    walls, steps = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        npz, saved = os.path.join(tmp, "frames.npz"), os.path.join(tmp, "points.json")
        counters = reset_counters()
        t_all = time.perf_counter()
        ed = PointEditor(i0, i1, stream=out, preview_cols=160, show_images=True, device=dev)

        def step(name, fn):
            before = read_counters(counters)
            t0 = time.perf_counter()
            fn()
            sync(dev)
            walls[name] = time.perf_counter() - t0
            after = read_counters(counters)
            steps[name] = {k: after[k] - before[k] for k in after if after[k] > before[k]}

        for (a, b) in pts:
            ed.cmd_add(*a, *b)
        step("cold_solve", ed.cmd_solve)
        ed.cmd_move(0, *moved[0, 0], *moved[0, 1])
        step("warm_solve", ed.cmd_solve)
        step("preview", lambda: ed.cmd_preview(0.5))
        step("cursor", lambda: ed.cmd_cursor(cursor_events(n, x_a, x_b)))
        step("render", lambda: ed.cmd_render(npz, 16))
        ed.cmd_save(saved)
        wall = time.perf_counter() - t_all
        launches = read_counters(counters)
        peak = peak_gib(dev)
        npz_frames = np.load(npz)["frames"]
        with open(saved) as f:
            saved_pts = np.asarray(json.load(f)["points"], np.float32)
    text = out.getvalue()
    log("  editor lines: " + json.dumps([ln for ln in text.splitlines() if "\x1b" not in ln]))
    log(f"  launches in the edit session: {launches}")
    for name, k in steps.items():
        log(f"  {name}: wall {walls[name]:.3f} s, launches {k}")
    log(f"  edit_1k: wall {wall:.3f} s (cold solve {walls['cold_solve']:.3f}, warm solve {walls['warm_solve']:.3f}, "
        f"preview {walls['preview']:.3f}, cursor + solve {walls['cursor']:.3f}, render 16 frames "
        f"{walls['render']:.3f}), {len(text) / 2**20:.1f} MiB of ANSI text, peak device memory {peak} on {card}")
    cold, warm = steps["cold_solve"].get("sweep_grad", 0), steps["warm_solve"].get("sweep_grad", 0)
    if torch.device(dev).type == "cuda":  # CPU tensors run the plain versions and count nothing
        for name in ("halfway_warp", "bilinear_sample", "sweep_grad", "sweep_energy"):
            require(launches[name] > 0, f"kernel {name} was not launched in the edit session")
        require(0 < warm < cold, f"the warm solve launched {warm} gradient kernels, the cold one {cold}")
    require(ed.solves == 3 and len(ed.pairs) == 5, f"{ed.solves} solves and {len(ed.pairs)} pairs")
    require(np.array_equal(saved_pts, np.concatenate([moved, fifth])), "the saved points are not the edits")
    require("▀" in text and text.count("solved in") == 3, "the editor printed no preview or not three solves")

    sess = api.Session(i0, i1, device=dev)
    for p in (pts, moved, np.concatenate([moved, fifth])):
        sess.update_points(p)
    v = ed.session.art.v
    require(torch.equal(sess.art.v, v), "the editor's field differs from api.Session given the same edits")
    ref = to_uint8(sess.render(16).cpu().numpy())
    require(npz_frames.shape == (16, n, n, 3) and np.array_equal(npz_frames, ref),
            f"the rendered .npz ({npz_frames.shape}) differs from Session.render(16)")
    hw = halfway_image(ed.session.i0, ed.session.i1, v, dev)
    g = grid_coords(n, n, v.dtype, v.device)
    plain = (0.5 * (kw.bilinear_sample_plain(ed.session.i0, g - v)
                    + kw.bilinear_sample_plain(ed.session.i1, g + v))).cpu().numpy()
    require(np.array_equal(hw, plain), f"halfway_image differs from the plain sampler by {np.abs(hw - plain).max()}")
    log(f"  the field equals api.Session's, the .npz Session.render(16)'s and the halfway view the plain "
        f"sampler's, bitwise; gradient launches cold {cold} > warm {warm}")
    return launches


def pairs_by_rows(dev, card: str) -> dict:
    """Phase 16: frame 0 of ``make_clips(1, *PAIRS_ROWS_HW, seed=s)``, s =
    0..3, with the bench's points rasterized at full resolution and a zero
    field, through ``make_spatial_level_solver(MorphParams(), 6, mesh,
    batch_axis="batch")`` on a (2, PAIRS_ROWS_BLOCKS) ("batch", "y") mesh
    of the card (two pairs a batch block, each pair's rows in
    PAIRS_ROWS_BLOCKS blocks; phase 2 holds the shard kernels at that
    block shape against their plain versions), then a t = 0.5
    render of each pair (linear blend, straight paths, as
    ``dryrun_multichip``). Each pair's field and stats must equal the 1-D
    solver's on a (PAIRS_ROWS_BLOCKS,) mesh for that pair alone, bitwise."""
    import torch

    from videomorphing_tpu_torch.config import MorphParams, SynthParams
    from videomorphing_tpu_torch.parallel.mesh import make_mesh
    from videomorphing_tpu_torch.parallel.spatial import make_spatial_level_solver
    from videomorphing_tpu_torch.solver.constraints import rasterize_point_constraints
    from videomorphing_tpu_torch.solver.energy import LevelData, make_level_data
    from videomorphing_tpu_torch.synth.render import render_frame
    from videomorphing_tpu_torch.utils.synthetic import make_clips

    (h, w), bsz, n_iters = PAIRS_ROWS_HW, 4, 6
    mp = MorphParams()
    pts = torch.from_numpy(bench_points(h, w)).to(dev)
    ui_w, ui_v = rasterize_point_constraints(pts, (h, w), mp.ui_sigma, torch.float32, dev)
    pairs = []
    for seed in range(bsz):
        clip_a, clip_b = make_clips(1, h, w, seed=seed)
        pairs.append(make_level_data(torch.from_numpy(clip_a[0]).to(dev), torch.from_numpy(clip_b[0]).to(dev),
                                     ui_w, ui_v))
    del clip_a, clip_b
    data = LevelData(*(torch.stack(f) for f in zip(*pairs)))
    nb = PAIRS_ROWS_BLOCKS
    mesh = make_mesh((2, nb), ("batch", "y"), devices=[dev] * (2 * nb))
    sp = SynthParams(blend_mode="linear", quadratic_paths=False)
    counters = reset_counters()
    t0 = time.perf_counter()
    v, st = make_spatial_level_solver(mp, n_iters, mesh, batch_axis="batch")(
        torch.zeros((bsz, h, w, 2), device=dev), data)
    sync(dev)
    t_solve = time.perf_counter() - t0
    frames = torch.stack([render_frame(d.i0, d.i1, v[i], None, 0.5, sp) for i, d in enumerate(pairs)])
    sync(dev)
    wall = time.perf_counter() - t0
    launches = read_counters(counters)
    peak = peak_gib(dev)
    log(f"  launches in the pairs x rows path: {launches}")
    shard = {k: launches[k] for k in ("sweep_grad_shard", "sweep_energy_shard", "halfway_warp_rows")}
    log(f"  pairs_rows_4k: wall {wall:.3f} s (solve {t_solve:.3f} s for {bsz} pairs x {n_iters} iterations, "
        f"renders {wall - t_solve:.3f} s), shard launches {shard}, peak device memory {peak}, "
        f"a (2, {nb}) mesh of one card (in turn) on {card}")
    for name in shard if torch.device(dev).type == "cuda" else ():
        require(launches[name] > 0, f"kernel {name} was not launched on the pairs x rows path")
    require(tuple(v.shape) == (bsz, h, w, 2) and tuple(st.iters.shape) == (bsz,), f"v {tuple(v.shape)}")
    check_frames(frames, (bsz, h, w, 3))
    solve1 = make_spatial_level_solver(mp, n_iters, make_mesh((nb,), ("y",), devices=[dev] * nb))
    for i, d in enumerate(pairs):
        v1, st1 = solve1(torch.zeros((h, w, 2), device=dev), d)
        same = (torch.equal(v[i], v1) and int(st.iters[i]) == st1.iters
                and all(float(getattr(st, f)[i]) == getattr(st1, f) for f in ("e0", "e_final", "step")))
        log(f"  pair {i}: iters {int(st.iters[i])}, e0 {float(st.e0[i]):.6f}, e_final {float(st.e_final[i]):.6f}; "
            f"max |dv| against the 1-D solver {float((v[i] - v1).abs().max()):.3e} (bitwise required)")
        require(same, f"pair {i} of the pairs x rows solve differs from the 1-D solver")
        require(float(st.e_final[i]) < float(st.e0[i]), f"pair {i}: energy did not decrease")
    del v, frames, data, pairs
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    return launches


def load_example(name: str):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_path(dev, card: str) -> dict:
    """Phase 17: ``compute`` of both port demos at their default shapes
    (the pair at 128 x 160, the video at 8 x 120 x 168): each demo's own
    check (the pair's disk centroid sweeps > 20 px towards B; the video's
    mid frame lands within 6 px of the takes' midpoint) and its ``.y4m``
    outputs, written by ``io.clips.save_clip`` (no PIL), starting with the
    YUV4MPEG2 magic."""
    from videomorphing_tpu_torch.io.clips import save_clip

    pair, video = load_example("demo_pair_torch"), load_example("demo_video_torch")
    counters = reset_counters()
    t0 = time.perf_counter()
    out_p = pair.compute(dev)
    sync(dev)
    t_pair = time.perf_counter() - t0
    out_v = video.compute((8, 120, 168), dev)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = read_counters(counters)
    log(f"  launches in the examples: {launches}")
    cs = out_p["centroids"]
    log(f"  demo_pair: {t_pair:.3f} s; disk centroid {np.round(cs, 2).tolist()}, max displacement "
        f"{out_p['disp']:.2f} px; demo_video: {wall - t_pair:.3f} s, mid-frame centroid "
        f"{out_v['mid_err']:.3f} px off the takes' midpoint (limit 6); on {card}")
    require(out_p["ok"], f"demo_pair: the disk centroid sweeps {cs[-1] - cs[0]} px (at least 20 required)")
    require(out_v["ok"], f"demo_video: the mid frame is {out_v['mid_err']} px off the takes' midpoint")
    for frames in (out_p["frames"], out_v["frames"], out_v["layered"]):
        require(np.isfinite(frames).all() and frames.min() >= 0.0 and frames.max() <= 1.0, "demo frames")
    with tempfile.TemporaryDirectory() as tmp:
        for name, frames in (("pair.y4m", out_p["frames"]), ("morph.y4m", out_v["frames"]),
                             ("layered.y4m", out_v["layered"])):
            path = os.path.join(tmp, name)
            save_clip(path, frames, fps=8)
            with open(path, "rb") as fh:
                require(fh.read(9) == b"YUV4MPEG2", f"{name} does not start with YUV4MPEG2")
    for name in BASE:
        require(launches[name] > 0, f"kernel {name} was not launched by the examples")
    return launches


def wide_pair(dev, card: str, mp) -> dict:
    """``api.morph_pair`` on the pair_1k inputs (4 points, 16 frames) at
    ``mp``: endpoints within 0.02, a monotone centroid, a bitwise rerun,
    every base kernel launched, and the wide strip's forms where its window
    runs them (none elsewhere). Returns the first run's launches."""
    import torch

    from videomorphing_tpu_torch import api
    from videomorphing_tpu_torch.kernels import sweep as ks

    n, n_frames, win = WIDE_PAIR_N, 16, mp.ssim_window
    what = f"window-{win}" + (" bf16" if mp.pack_dtype == "bfloat16" else "")
    i0, i1, pts = make_pair(n)
    counters = reset_counters()
    t0 = time.perf_counter()
    frames = api.morph_pair(i0, i1, pts, n_frames=n_frames, mp=mp, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters(counters)
    log(f"  launches in the {what} pair path: {launches}")
    check_frames(frames, (n_frames, n, n, 3))
    for name in BASE:
        require(launches[name] > 0, f"kernel {name} was not launched on the {what} pair path")
    wide = ks.wide_strip(True, ks.kernel_radius(mp))
    sfx = "_bf16" if mp.pack_dtype == "bfloat16" else ""
    for name in ("sweep_grad_wide" + sfx, "sweep_energy_wide" + sfx):
        require((launches[name] > 0) == wide, f"{name}: {launches[name]} launches on the {what} pair path")
    check_endpoints(frames.cpu().numpy(), i0, i1, f"{what} pair")
    cx = centroids_x(frames)
    ca, cb = centroids_x(torch.from_numpy(np.stack([i0, i1])).to(dev))
    log(f"  centroid x per frame: {np.round(cx, 2).tolist()} (A {ca:.2f}, B {cb:.2f})")
    require(np.all(np.diff(cx) >= 0.0), f"{what}: centroid does not move monotonically")
    require(abs(cx[0] - ca) < 0.01 * n and abs(cx[-1] - cb) < 0.01 * n, f"{what}: centroid misses A or B")
    again = api.morph_pair(i0, i1, pts, n_frames=n_frames, mp=mp, device=dev)
    require(torch.equal(frames, again), f"{what}: the pair morph's rerun is not bitwise identical")
    log(f"  pair_1k at {what}: wall {wall:.3f} s for solve + {n_frames} frames (first call), "
        f"rerun bitwise equal, on {card}")
    return launches


def wide_spatial(dev, card: str, win: int) -> dict:
    """Frame 0 of the bench's 2160 x 3840 pair through
    ``optimize_pair_spatial`` on 4 row blocks of the card at ``ssim_window``
    ``win`` (reach 2R rows, exchange halo 2R + 2), its field bitwise equal to
    the single-device ``api.solve_pair``; at a window of the wide strip its
    shard forms launched. Returns the sharded solve's launches."""
    import torch

    from videomorphing_tpu_torch import api
    from videomorphing_tpu_torch.config import MorphParams
    from videomorphing_tpu_torch.kernels import sweep as ks
    from videomorphing_tpu_torch.ops.pyramid import pyramid_shapes
    from videomorphing_tpu_torch.parallel.mesh import make_mesh
    from videomorphing_tpu_torch.parallel.spatial import exchange_halo, level_is_sharded, optimize_pair_spatial
    from videomorphing_tpu_torch.utils.synthetic import make_clips

    (h, w), n_blocks = SPATIAL_HW, 4
    mp = MorphParams(ssim_window=win, ssim_sigma=WINDOW_SIGMA[win])
    clip_a, clip_b = make_clips(1, h, w, seed=0)
    i0 = torch.from_numpy(clip_a[0]).to(dev)
    i1 = torch.from_numpy(clip_b[0]).to(dev)
    del clip_a, clip_b
    pts = bench_points(h, w)
    mesh = make_mesh((n_blocks,), ("y",), devices=[dev] * n_blocks)
    t0 = time.perf_counter()
    single = api.solve_pair(i0, i1, pts, mp, device=dev)
    torch.cuda.synchronize()
    t_single = time.perf_counter() - t0
    counters = reset_counters()
    t0 = time.perf_counter()
    res = optimize_pair_spatial(i0, i1, pts, mp, mesh)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    launches = read_counters(counters)
    log(f"  launches in the window-{win} spatial path: {launches}")
    names = ["sweep_grad_shard", "sweep_energy_shard", "halfway_warp_rows"]
    if ks.wide_strip(True, ks.kernel_radius(mp)):
        names += ["sweep_grad_shard_wide", "sweep_energy_shard_wide"]
    for name in names:
        require(launches[name] > 0, f"kernel {name} was not launched on the window-{win} spatial path")
    require(ks.shard_reach(mp) == 2 * (win // 2) and exchange_halo(mp) == 2 * (win // 2) + 2,
            f"window {win}: reach {ks.shard_reach(mp)}, exchange halo {exchange_halo(mp)}")
    shapes = pyramid_shapes(h, w, res.n_levels)
    for li, st in enumerate(res.level_stats):
        lh, lw = shapes[res.n_levels - 1 - li]
        kind = "sharded" if level_is_sharded(lh, n_blocks, mp) else "local"
        log(f"  level {lh}x{lw} {kind}: iters={st.iters} e0={st.e0:.6f} e_final={st.e_final:.6f}")
        require(st.e_final < st.e0, f"level {lh}x{lw}: energy did not decrease")
    dv = float((single.v - res.v).abs().max())
    log(f"  spatial_4k at window {win}: sharded solve {t_solve:.3f} s after a single-device solve of "
        f"{t_single:.3f} s; reach {ks.shard_reach(mp)} rows, exchange halo {exchange_halo(mp)}; "
        f"max |dv| against the single-device field {dv:.3e} px; peak {peak_gib(dev)}")
    require(torch.equal(single.v, res.v), f"window {win}: the sharded 4K field differs from the single-device one")
    del single, res, i0, i1
    torch.cuda.empty_cache()
    return launches


def wide_windows(dev, card: str) -> dict:
    """Phase 18: SSIM windows other than the default through the entry
    points. ``wide_pair`` at ``WIDE_PAIR_WINDOW`` (sigma 1.5, the tiled
    kernels at R = 5) and at ``WIDE_PAIR_WINDOWS`` (the tiles at R = 0; the
    wide strip at R = 8, float32 and bf16); ``utils.golden.run_golden`` at
    ``WIDE_PAIR_WINDOW`` (midpoint SSIM >= 0.99 each); ``wide_spatial`` at
    ``WIDE_SPATIAL_WINDOWS`` (9: the strips at R = 4; 17: the wide strip's
    shard forms at full width). Returns the launches of the runs (the
    reruns and the single-device solves left out), summed."""
    from videomorphing_tpu_torch.config import MorphParams
    from videomorphing_tpu_torch.utils.golden import run_golden

    total: dict = {}

    def add(launches):
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n

    win = WIDE_PAIR_WINDOW
    mp = MorphParams(ssim_window=win, ssim_sigma=1.5)
    pairs = [mp] + [MorphParams(ssim_window=k, ssim_sigma=WINDOW_SIGMA[k]) for k in WIDE_PAIR_WINDOWS]
    pairs.append(MorphParams(ssim_window=WIDE_PAIR_WINDOWS[-1], ssim_sigma=WINDOW_SIGMA[WIDE_PAIR_WINDOWS[-1]],
                             pack_dtype="bfloat16"))
    for mpk in pairs:
        add(wide_pair(dev, card, mpk))

    # the golden cases at window 11
    counters = reset_counters()
    t0 = time.perf_counter()
    for case in ("translation", "rotation", "scale"):
        r = run_golden(case, hw=GOLDEN_HW, mp=mp, device=dev)
        log(f"  golden {case} {GOLDEN_HW[0]}x{GOLDEN_HW[1]} window {win}: ssim_mid {r['ssim_mid']}, "
            f"v_err_mean {r['v_err_mean']} px, v_err_p99 {r['v_err_p99']} px")
        require(r["ssim_mid"] >= 0.99, f"golden {case} at window {win}: midpoint SSIM {r['ssim_mid']} < 0.99")
    sync(dev)
    launches = read_counters(counters)
    log(f"  golden at window {win}: wall {time.perf_counter() - t0:.3f} s for 3 cases; launches {launches}")
    add(launches)

    # the 4K spatial solves against the single-device solves
    for win in WIDE_SPATIAL_WINDOWS:
        add(wide_spatial(dev, card, win))
    return total


@contextlib.contextmanager
def record_forms():
    """The set of (kind, rows, columns, plane dtype) of every sweep gradient
    the level solvers ask for inside the block: ``descent.sweep_grad`` on a
    whole level ("level"), ``spatial.sweep_grad_shard`` on a row block's
    owned rows ("block"). The calls go on to the wrappers as before, so the
    launch counts are unchanged."""
    from videomorphing_tpu_torch.parallel import spatial
    from videomorphing_tpu_torch.solver import descent

    seen: set = set()
    grad, shard = descent.sweep_grad, spatial.sweep_grad_shard
    # a level's steps run in Python only when its graphs are captured: drop
    # the graphs, so that every level of the block is seen
    descent._graphs.clear()

    def whole(planes, v_lin, v, data, p):
        seen.add(("level", planes.shape[1], planes.shape[2], planes.dtype))
        return grad(planes, v_lin, v, data, p)

    def block(planes, v_lin, v, data, p, row0, gh, halo):
        seen.add(("block", planes.shape[1] - 2 * halo, planes.shape[2], planes.dtype))
        return shard(planes, v_lin, v, data, p, row0, gh, halo)

    descent.sweep_grad, spatial.sweep_grad_shard = whole, block
    try:
        yield seen
    finally:
        descent.sweep_grad, spatial.sweep_grad_shard = grad, shard


def check_level_forms(seen: set, mp, what: str) -> None:
    """Every level (or row block's owned rows) of at least
    ``mp.pallas_min_pixels`` pixels ran the bf16 form and every smaller one
    the float32 form (``backend="auto"`` on the card), and both ran."""
    import torch

    wrong = sorted((kind, rows, cols, str(dt)) for kind, rows, cols, dt in seen
                   if dt != (torch.bfloat16 if rows * cols >= mp.pallas_min_pixels else torch.float32))
    forms = sorted({(kind, rows, cols, str(dt).replace("torch.", "")) for kind, rows, cols, dt in seen})
    log(f"  {what} forms by level: {forms}")
    require(not wrong, f"{what}: levels ran the wrong form: {wrong}")
    require({dt for *_, dt in seen} == {torch.float32, torch.bfloat16},
            f"{what}: expected float32 levels under {mp.pallas_min_pixels} px and bf16 levels above")


def bf16_pack(dev, card: str) -> dict:
    """Phase 19: ``pack_dtype="bfloat16"`` (``backend="auto"``) through the
    entry points: ``api.morph_pair`` on phase 3's inputs (endpoints within
    0.02, a bitwise rerun, the field's median and max |dv| against phase
    3's float32 field, printed without a gate: the float32 solve itself
    moves 0.18 px under 1e-7 px of input noise); ``api.morph_clips`` on
    phase 5's clip pair (``BF16_VIDEO_THW``: shapes, a monotone blob
    centroid from clip A's first frame to clip B's last); the 4K pair
    through ``optimize_pair_spatial`` on 4 row blocks of the card (a
    monotone blob centroid of 16 frames); ``run_golden`` (SSIM >= 0.99,
    translation error < 0.1 px). Each with its wall and launches, and the
    forms by level (``record_forms``): float32 under ``pallas_min_pixels``,
    bf16 from there. Returns the launches of the four runs (the pair's
    rerun left out), summed."""
    import torch

    from videomorphing_tpu_torch import api
    from videomorphing_tpu_torch.config import MorphParams, SynthParams
    from videomorphing_tpu_torch.models.image_morph import ImageMorpher, MorphArtifacts
    from videomorphing_tpu_torch.parallel.mesh import make_mesh
    from videomorphing_tpu_torch.parallel.spatial import optimize_pair_spatial
    from videomorphing_tpu_torch.synth.paths import bulge_field
    from videomorphing_tpu_torch.utils.golden import run_golden
    from videomorphing_tpu_torch.utils.synthetic import make_clips
    from videomorphing_tpu_torch.video.pipeline import _default_times

    mp = MorphParams(pack_dtype="bfloat16")
    forms16 = [f"{name}_bf16" for name in BF16_FORMS]
    total: dict = {}

    def add(launches):
        for name, k in launches.items():
            total[name] = total.get(name, 0) + k

    # the pair
    n, n_frames = 1024, 16
    i0, i1, pts = make_pair(n)
    counters = reset_counters()
    t0 = time.perf_counter()
    with record_forms() as seen:
        frames = api.morph_pair(i0, i1, pts, n_frames=n_frames, mp=mp, device=dev)
        sync(dev)
    wall = time.perf_counter() - t0
    launches = read_counters(counters)
    log(f"  launches in the bf16 pair path: {launches}")
    check_level_forms(seen, mp, "bf16 pair")
    for name in ("halfway_warp", "sweep_grad", "sweep_energy"):
        require(launches[name] > 0 and launches[name + "_bf16"] > 0,
                f"{name}: the pair path launched {launches[name]} float32 and {launches[name + '_bf16']} bf16 forms")
    check_frames(frames, (n_frames, n, n, 3))
    check_endpoints(frames.cpu().numpy(), i0, i1, "bf16 pair")
    again = api.morph_pair(i0, i1, pts, n_frames=n_frames, mp=mp, device=dev)
    require(torch.equal(frames, again), "bf16: the pair morph's rerun is not bitwise identical")
    del frames, again
    # phase 3's float32 field, solved again (the solve is bitwise repeatable)
    dv = (api.solve_pair(i0, i1, pts, mp, device=dev).v - api.solve_pair(i0, i1, pts, device=dev).v).abs()
    log(f"  pair_1k bf16: wall {wall:.3f} s for solve + {n_frames} frames (first call), rerun bitwise equal; "
        f"field against phase 3's float32 field: median |dv| {float(dv.median()):.3e} px, "
        f"max {float(dv.max()):.3e} px (no gate) on {card}")
    add(launches)

    # the clip pair
    t_len, h, w = BF16_VIDEO_THW
    clip_a, clip_b = make_clips(t_len, h, w, seed=0)
    ca, cb = torch.from_numpy(clip_a).to(dev), torch.from_numpy(clip_b).to(dev)
    del clip_a, clip_b
    counters = reset_counters()
    t0 = time.perf_counter()
    with record_forms() as seen:
        res = api.morph_clips(ca, cb, bench_points(h, w), mp=mp, device=dev)
        sync(dev)
    wall = time.perf_counter() - t0
    launches = read_counters(counters)
    log(f"  launches in the bf16 video path: {launches}")
    check_level_forms(seen, mp, "bf16 video")
    for name in ("halfway_warp", "sweep_grad", "sweep_energy"):
        require(launches[name + "_bf16"] > 0, f"{name}_bf16 was not launched on the video path")
    check_frames(res.frames, (t_len, h, w, 3))
    cx = np.concatenate([blob_centroids_x(res.frames[k:k + 10]) for k in range(0, t_len, 10)])
    ca0, cb_end = blob_centroids_x(ca[:1])[0], blob_centroids_x(cb[-1:])[0]
    log(f"  blob centroid x per frame: {np.round(cx, 2).tolist()} (A[0] {ca0:.2f}, B[{t_len - 1}] {cb_end:.2f})")
    require(np.all(np.diff(cx) > 0.0), "bf16 video: blob centroid does not rise monotonically")
    require(abs(cx[0] - ca0) < 0.01 * w and abs(cx[-1] - cb_end) < 0.01 * w,
            "bf16 video: blob centroid misses clip A's first or clip B's last frame")
    log(f"  video_1080p bf16: wall {wall:.3f} s for {t_len} frames, {t_len / wall:.3f} frames/s, "
        f"peak {peak_gib(dev)} on {card}")
    add(launches)
    del res, ca, cb
    torch.cuda.empty_cache()

    # the 4K pair on 4 row blocks
    (h, w), n_blocks = SPATIAL_HW, 4
    clip_a, clip_b = make_clips(1, h, w, seed=0)
    i0, i1 = torch.from_numpy(clip_a[0]).to(dev), torch.from_numpy(clip_b[0]).to(dev)
    del clip_a, clip_b
    mesh = make_mesh((n_blocks,), ("y",), devices=[dev] * n_blocks)
    counters = reset_counters()
    t0 = time.perf_counter()
    with record_forms() as seen:
        res = optimize_pair_spatial(i0, i1, bench_points(h, w), mp, mesh)
        sync(dev)
    t_solve = time.perf_counter() - t0
    art = MorphArtifacts(v=res.v, b=bulge_field(res.v, SynthParams()), result=res)
    frames = ImageMorpher(mp, device=str(dev)).render(i0, i1, art, _default_times(n_frames, "cpu"))
    sync(dev)
    wall = time.perf_counter() - t0
    launches = read_counters(counters)
    log(f"  launches in the bf16 spatial path: {launches}")
    check_level_forms(seen, mp, "bf16 spatial")
    require({kind for kind, *_ in seen} == {"level", "block"}, "bf16 spatial: no sharded or no local level")
    for name in ("halfway_warp_rows", "sweep_grad_shard", "sweep_energy_shard"):
        require(launches[name + "_bf16"] > 0, f"{name}_bf16 was not launched on the spatial path")
    check_frames(frames, (n_frames, h, w, 3))
    cx = blob_centroids_x(frames)
    require(np.all(np.diff(cx) > 0.0), "bf16 spatial: blob centroid does not rise monotonically")
    log(f"  spatial_4k bf16: sharded solve {t_solve:.3f} s, wall {wall:.3f} s with {n_frames} frames, "
        f"peak {peak_gib(dev)}, {n_blocks} row blocks on one card (in turn) on {card}")
    add(launches)
    del frames, res, art, i0, i1
    torch.cuda.empty_cache()

    # the golden cases
    counters = reset_counters()
    t0 = time.perf_counter()
    with record_forms() as seen:
        for case in ("translation", "rotation", "scale"):
            r = run_golden(case, hw=GOLDEN_HW, mp=mp, device=dev)
            log(f"  golden {case} {GOLDEN_HW[0]}x{GOLDEN_HW[1]} bf16: ssim_mid {r['ssim_mid']}, "
                f"v_err_mean {r['v_err_mean']} px, v_err_p99 {r['v_err_p99']} px")
            require(r["ssim_mid"] >= 0.99, f"golden {case} bf16: midpoint SSIM {r['ssim_mid']} < 0.99")
            if case == "translation":
                require(r["v_err_mean"] < 0.1, f"golden translation bf16: mean field error {r['v_err_mean']} >= 0.1 px")
        sync(dev)
    launches = read_counters(counters)
    check_level_forms(seen, mp, "bf16 golden")
    log(f"  golden bf16: wall {time.perf_counter() - t0:.3f} s for 3 cases; launches {launches}")
    add(launches)
    require(all(total[name] > 0 for name in forms16), f"bf16 forms not launched in phase 19: {total}")
    return total


def check_bench_line(config: str, line: dict) -> None:
    """A line of the port's bench: its config's keys, a positive value (the
    kernels line's, an error, may be 0); the headline's and the kernels
    line's kernels compiled and within ``KERNEL_TOLERANCE``, the golden
    SSIM 0.99 or more."""
    from videomorphing_tpu_torch import bench as tbench

    keys = set(tbench.LINE_KEYS[config])
    require(set(line) == keys, f"bench {config}: keys {sorted(line)}, expected {sorted(keys)}")
    value = line["value"]
    require(isinstance(value, (int, float)) and (value >= 0 if config == "kernels" else value > 0),
            f"bench {config}: value {value}")
    if keys == set(tbench.HEADLINE_KEYS):
        err, ssim = line["kernel_max_rel_err"], line["golden_midpoint_ssim"]
        require(line["vs_baseline"] is None and line["kernel_compiled"] is True,
                f"bench {config}: vs_baseline {line['vs_baseline']}, kernel_compiled {line['kernel_compiled']}")
        require(isinstance(err, float) and err <= max(tbench.KERNEL_TOLERANCE.values()),
                f"bench {config}: kernel_max_rel_err {err}")
        require(isinstance(ssim, float) and ssim >= tbench.GOLDEN_MIN_SSIM,
                f"bench {config}: golden_midpoint_ssim {ssim}")
    elif config == "kernels":
        require(line["compiled"] is True and tbench.kernels_ok(line), f"bench kernels: {line}")
    elif config == "golden":
        require(line["value"] >= tbench.GOLDEN_MIN_SSIM, f"bench golden: {line['value']} < 0.99")


def bench_config(config: str, card: str) -> None:
    """``bench.main([config])`` in this process: exit 0, one line, checked."""
    from io import StringIO

    from videomorphing_tpu_torch import bench as tbench

    buf = StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = tbench.main([config])
    wall = time.perf_counter() - t0
    lines = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
    require(rc == 0 and len(lines) == 1, f"bench {config} returned {rc}: {buf.getvalue()}")
    check_bench_line(config, lines[0])
    log(f"  bench {config} ({wall:.2f} s) on {card}: {json.dumps(lines[0])}")


@contextlib.contextmanager
def kernel_checks_uncounted():
    """``bench.bench_kernels``, which a headline line runs, with its
    launches taken back out of the counters: they compare the kernels
    with their plain versions, and count apart from the path's."""
    from videomorphing_tpu_torch import bench as tbench

    checks = tbench.bench_kernels

    def uncounted(*args, **kwargs):
        counters = kernel_counters()
        before = read_counters(counters)
        try:
            return checks(*args, **kwargs)
        finally:
            for name, fn, attr in counters:
                setattr(fn, attr, before[name])

    tbench.bench_kernels = uncounted
    try:
        yield
    finally:
        tbench.bench_kernels = checks


def bench_path(dev, card: str) -> dict:
    """Phase 20: the port's bench. ``python -m videomorphing_tpu_torch.cli
    bench`` in a child process (no ``BENCH_*`` variables: video_1080p, 3
    repeats), then ``BENCH_PATH_CONFIGS`` in this process, then
    ``kernels``; every line checked by ``check_bench_line``. Returns the
    in-process configs' launches, without those of the kernel checks
    (comparisons: the ``kernels`` config's are read apart, video_480p's
    left out by ``kernel_checks_uncounted``)."""
    import torch

    t_phase = time.perf_counter()
    for name in [k for k in os.environ if k.startswith("BENCH_")]:
        del os.environ[name]
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "videomorphing_tpu_torch.cli", "bench"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    require(out.returncode == 0, f"cli bench exited {out.returncode}:\n{out.stdout}\n{out.stderr[-4000:]}")
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    require(len(lines) == 1, f"cli bench printed {len(lines)} lines:\n{out.stdout}")
    check_bench_line("video_1080p", lines[0])
    summary = [x for x in out.stderr.splitlines() if x.startswith("# ")]
    log(f"  cli bench ({wall:.2f} s with process start) on {card}: {json.dumps(lines[0])}")
    log(f"  cli bench: {summary[-1] if summary else 'no summary line'}")

    counters = reset_counters()
    with kernel_checks_uncounted():
        for config in BENCH_PATH_CONFIGS:
            bench_config(config, card)
    sync(dev)
    launches = read_counters(counters)
    log("  launches of the in-process configs: " + json.dumps({n: launches[n] for n in BASE}))
    require(all(launches[n] > 0 for n in BASE), f"phase 20 left a kernel unlaunched: {launches}")

    counters = reset_counters()
    bench_config("kernels", card)
    compared = read_counters(counters)
    log("  launches of the kernels check: " + json.dumps({n: compared[n] for n in BENCH_CHECKED}))
    require(all(compared[n] > 0 for n in BENCH_CHECKED), f"the kernels check left a counter at 0: {compared}")
    log(f"  phase 20: {time.perf_counter() - t_phase:.1f} s")
    return launches


RENDER_GRAPH_TIMES = (0.0, 1.0 / 119.0, 0.25, 0.5, 0.75, 1.0)


def render_graphs(dev, card: str) -> dict:
    """Phase 21: ``render_frame`` on the card replays a CUDA graph of its
    body, bitwise equal to the eager body (``render._render_frame_eager``)."""
    import torch

    from videomorphing_tpu_torch.config import SynthParams
    from videomorphing_tpu_torch.kernels.warp import bilinear_sample, bilinear_sample_batched
    from videomorphing_tpu_torch.ops import poisson, pyramid
    from videomorphing_tpu_torch.synth import render
    from videomorphing_tpu_torch.utils import profiling

    counters = reset_counters()
    samplers = (bilinear_sample, bilinear_sample_batched)

    def case(h, w, c, with_conf, seed):
        rng = np.random.default_rng(seed)
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)
        conf = (put(rng.random((h, w))), put(rng.random((h, w)))) if with_conf else (None, None)
        return (put(rng.random((h, w, c))), put(rng.random((h, w, c))), put(smooth_field(h, w, 24.0, seed)),
                put(smooth_field(h, w, 6.0, seed + 1))) + conf

    def eager(args, t, sp=SynthParams()):
        i0, i1, v, b, c0, c1 = args
        return render._render_frame_eager(i0, i1, v, b, render._time_vector(t, v), sp, c0, c1, False)

    def frame(args, t, sp=SynthParams(), **kw):
        i0, i1, v, b, c0, c1 = args
        return render.render_frame(i0, i1, v, b, t, sp, conf0=c0, conf1=c1, **kw)

    def launched(fn):
        before = [s.launches for s in samplers]
        out = fn()
        torch.cuda.synchronize()
        return out, [s.launches - n for s, n in zip(samplers, before)]

    def same(args, t, what, sp=SynthParams()):
        """A graph frame against the eager body; returns the graph frame
        and whether it captured (a new key)."""
        keys = set(render._graphs.keys())
        want, per_frame = launched(lambda: eager(args, t, sp))
        got, counted = launched(lambda: frame(args, t, sp))
        captured = bool(set(render._graphs.keys()) - keys)
        require(torch.equal(got, want),
                f"{what}, t = {t}: the replay differs from the eager body by {float((got - want).abs().max())}")
        require(counted == [n * (2 if captured else 1) for n in per_frame],
                f"{what}, t = {t}: kernel 4 counted {counted}, one frame launches {per_frame}, "
                f"captured: {captured}")
        return got, captured

    render._graphs.clear()
    a = case(1024, 1024, 3, False, 2101)
    video = case(1080, 1920, 4, True, 2102)
    for args, what in ((a, "1024^2, C = 3, a bulge"), (video, "1080x1920, C = 4, a bulge, confidences")):
        caps = [same(args, t, what)[1] for t in RENDER_GRAPH_TIMES]
        require(caps == [True] + [False] * (len(caps) - 1), f"{what}: captures at {caps}")
        log(f"  {what}: {len(caps)} times bitwise the eager body, one capture, kernel 4's counters honest")

    poisson._dct_mat.cache_clear()
    pyramid._resize_weights.cache_clear()
    for h, w in ((512, 512), (768, 1024), (1024, 768)):
        eager(case(h, w, 3, False, h + w), 0.5)
    same(case(512, 512, 3, False, 2103), 0.3, "512^2 after the caches were cleared")
    for t in (0.2, 0.6):
        _, cap = same(a, t, "1024^2 after the caches were cleared and refilled by other shapes")
        require(not cap, "the 1024^2 graph was captured again")
    log("  replays after the constant caches were cleared and refilled: bitwise, no capture")

    plain = frame(a, 0.5)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf, cap = same(a, 0.5, "1024^2 under TF32")
        require(cap, "a TF32 flip did not capture a graph of its own")
        require(not torch.equal(tf, plain), "the TF32 frame equals the float32 frame")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    _, cap = same(a, 0.5, "1024^2 back in float32")
    require(not cap, "the float32 graph was captured again after the TF32 flip")
    log(f"  TF32 flip: a graph of its own, bitwise eager TF32, max |TF32 - float32| "
        f"{float((tf - plain).abs().max()):.3g}")

    small = case(512, 512, 3, True, 2104)
    for sp, what in ((SynthParams(sampling="bicubic"), "bicubic"), (SynthParams(blend_mode="linear"), "linear blend")):
        for t in (0.0, 0.4):
            same(small, t, f"512^2, {what}", sp)
    strided = tuple(None if x is None else x.transpose(0, 1).contiguous().transpose(0, 1) for x in small)
    same(strided, 0.4, "512^2, non-contiguous inputs")
    keys = len(render._graphs.keys())
    _, aux = frame(small, 0.4, with_aux=True)
    require(len(render._graphs.keys()) == keys, "with_aux=True captured a graph")
    require(len(render._graphs.keys()) <= render.GRAPHS_KEPT, f"{len(render._graphs.keys())} graphs kept")
    log(f"  bicubic, linear blend, non-contiguous inputs bitwise; with_aux eager; {keys} graphs kept "
        f"(at most {render.GRAPHS_KEPT})")

    with profiling.record_phases():
        for t in (0.1, 0.2):
            with profiling.span("render.frame"):
                frame(case(256, 384, 3, False, 2105), t)
    spans = [s for s in profiling.spans() if s.name == "render.frame"][-2:]
    counts = [s.counts for s in spans]
    require(counts == [{"graph_captures": 1, "graph_replays": 1}, {"graph_replays": 1}],
            f"render.frame counters {counts}")
    log(f"  render.frame counters: {counts}")

    for args, what in ((a, "1024^2"), (video, "1080x1920")):
        g_ms, e_ms = cuda_ms(lambda: frame(args, 0.5)), cuda_ms(lambda: eager(args, 0.5))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            frame(args, 0.5)
        issued = time.perf_counter() - t0
        torch.cuda.synchronize()
        done = time.perf_counter() - t0
        log(f"  {what} frame call: replayed {g_ms:.3f} ms, eager {e_ms:.3f} ms ({e_ms / g_ms:.2f}x); 20 replays "
            f"back to back issued in {1e3 * issued / 20:.3f} ms a frame, done in {1e3 * done / 20:.3f} on {card}")
    log(f"  peak memory {peak_gib(dev)}")
    return read_counters(counters)


@contextlib.contextmanager
def eager_levels():
    """Every level solve inside the block runs its steps eagerly, as on the
    CPU (``descent.replayable`` answers no)."""
    from videomorphing_tpu_torch.solver import descent

    replayable = descent.replayable
    descent.replayable = lambda tensors: False
    try:
        yield
    finally:
        descent.replayable = replayable


def same_level_stats(a, b) -> bool:
    """Two ``LevelStats`` equal field for field, the histories' NaNs in
    the same places."""
    import torch

    return ((a.e0, a.e_final, a.iters, a.step) == (b.e0, b.e_final, b.iters, b.step)
            and torch.equal(a.energy_history.isnan(), b.energy_history.isnan())
            and torch.equal(a.energy_history.nan_to_num(), b.energy_history.nan_to_num()))


def solver_graphs(dev, card: str) -> dict:
    """Phase 22: the level solver on the card replays CUDA graphs of its
    steps, bitwise the eager loop (``eager_levels``)."""
    import dataclasses

    import torch

    from videomorphing_tpu_torch.config import MorphParams, VideoParams
    from videomorphing_tpu_torch.solver import descent
    from videomorphing_tpu_torch.solver.constraints import rasterize_point_constraints
    from videomorphing_tpu_torch.solver.ctf import optimize_pair
    from videomorphing_tpu_torch.solver.energy import make_level_data
    from videomorphing_tpu_torch.utils import profiling
    from videomorphing_tpu_torch.utils.synthetic import make_clips
    from videomorphing_tpu_torch.video.pipeline import _make_warm_solver

    counters = reset_counters()
    descent._graphs.clear()
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    def pair(h, w, seed):
        clip_a, clip_b = make_clips(1, h, w, seed=seed)
        return put(clip_a[0]), put(clip_b[0]), put(bench_points(h, w))

    def timed(fn):
        """(fn(), its wall in s, the launches it counted, the new
        ``solve.level`` spans)."""
        profiling.clear()
        before = read_counters(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profiling.record_phases():
            out = fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = read_counters(counters)
        levels = [s for s in profiling.spans() if s.name == "solve.level"]
        return out, wall, {k: after[k] - before[k] for k in after if after[k] != before[k]}, levels

    def check_spans(levels, what, captures):
        for s in levels:
            c = s.counts
            require(c.get("graph_iters") == s.attrs["iters"] and c.get("reads") == c.get("armijo_trials"),
                    f"{what}: level {s.attrs['h']}x{s.attrs['w']} counted {c}, {s.attrs['iters']} iterations")
        got = sum(s.counts.get("graph_captures", 0) for s in levels)
        require(got == captures, f"{what}: {got} captures, expected {captures}")

    for (h, w), overrides, n in SOLVER_GRAPH_CASES:
        p = dataclasses.replace(MorphParams(), **overrides)
        i0, i1, pts = pair(h, w, h + w)
        ui_w, ui_v = rasterize_point_constraints(pts, (h, w), p.ui_sigma, torch.float32, dev)
        data = make_level_data(i0, i1, ui_w, ui_v)
        v0 = put(smooth_field(h, w, 2.0, h))
        what = f"{h}x{w} {overrides or 'defaults'}, {n} iterations"
        with eager_levels():
            (v_e, st_e), t_e, l_e, _ = timed(lambda: descent.make_level_solver(p, n)(v0, data))
        runs = [timed(lambda: descent.make_level_solver(p, n)(v0, data)) for _ in range(2)]
        for k, ((v_g, st_g), _, l_g, levels) in enumerate(runs):
            require(torch.equal(v_g, v_e) and same_level_stats(st_g, st_e),
                    f"{what}, replay {k}: max |dv| {float((v_g - v_e).abs().max()):.3e}, stats {st_g} / {st_e}")
            check_spans(levels, what, int(k == 0))
        dt = descent.pack_dtype_for(p, h, w, dev)
        sfx = "_bf16" if dt == torch.bfloat16 else ""
        warm_up = {"halfway_warp" + sfx: 1, "sweep_grad" + sfx: p.n_colors, "sweep_energy" + sfx: p.n_colors + 1}
        first = {k: runs[0][2].get(k, 0) - l_e.get(k, 0) for k in set(runs[0][2]) | set(l_e)}
        require({k: v for k, v in first.items() if v} == warm_up and runs[1][2] == l_e,
                f"{what}: launches eager {l_e}, replayed {runs[0][2]} then {runs[1][2]}")
        log(f"  {what}: bitwise the eager loop (iters {st_e.iters}, e {st_e.e0:.6f} -> {st_e.e_final:.6f}), "
            f"one capture; eager {1e3 * t_e:.1f} ms, replayed {1e3 * runs[1][1]:.1f} ms "
            f"({1e3 * runs[1][1] / max(st_e.iters, 1):.3f} ms an iteration) on {card}")

    def whole_pair(n, seed):
        i0, i1, pts = pair(n, n, seed)
        return lambda: optimize_pair(i0, i1, pts, MorphParams(n_levels=5))

    solve_a = whole_pair(SOLVER_GRAPH_PAIR_N, 2201)
    descent._graphs.clear()
    with eager_levels():
        want, t_e, _, _ = timed(solve_a)
    got, t_first, _, levels = timed(solve_a)
    check_spans(levels, "optimize_pair, first", len(got.level_stats))
    require(torch.equal(got.v, want.v) and all(map(same_level_stats, got.level_stats, want.level_stats)),
            "optimize_pair: the replays differ from the eager loop")
    got2, t_g, _, levels = timed(whole_pair(SOLVER_GRAPH_PAIR_N, 2202))
    check_spans(levels, "optimize_pair, a second pair", 0)
    log(f"  optimize_pair {SOLVER_GRAPH_PAIR_N}^2, 5 levels, 4 points: bitwise the eager loop, "
        f"{sum(s.iters for s in got.level_stats)} iterations; eager {t_e:.3f} s, first (captures) {t_first:.3f} s, "
        f"a second pair {t_g:.3f} s, no capture; {len(descent._graphs.keys())} levels kept")

    (h, w), vp = SOLVER_GRAPH_VIDEO_HW, VideoParams()
    i0, i1, pts = pair(h, w, 2203)
    v_init = put(smooth_field(h, w, 3.0, 2204))
    tc_w = torch.full((h, w, 1), 0.5, device=dev)
    warm = _make_warm_solver(MorphParams(), (h, w), vp)
    with eager_levels():
        (v_e, it_e), t_e, _, _ = timed(lambda: warm(i0, i1, pts, v_init, v_init, tc_w))
    runs = [timed(lambda: warm(i0, i1, pts, v_init, v_init, tc_w)) for _ in range(2)]
    for (v_g, it_g), _, _, levels in runs:
        require(torch.equal(v_g, v_e) and it_g == it_e, f"video warm solve: the replays differ ({it_g} / {it_e})")
    check_spans(runs[1][3], "video warm solve, again", 0)
    log(f"  video warm solve {h}x{w} ({it_e} iterations): bitwise the eager loop; eager {1e3 * t_e:.1f} ms, "
        f"replayed {1e3 * runs[1][1]:.1f} ms")

    descent._graphs.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    h, w = SOLVER_GRAPH_4K_HW
    i0, i1, _ = pair(h, w, 2205)
    solve_4k = lambda: optimize_pair(i0, i1, None, MorphParams())
    got, t_first, _, levels = timed(solve_4k)
    check_spans(levels, "4K optimize_pair", len(got.level_stats))
    kept = torch.cuda.memory_allocated() - base
    peak = torch.cuda.max_memory_allocated() - base
    with eager_levels():
        want, t_e, _, _ = timed(solve_4k)
    got, t_g, _, levels = timed(solve_4k)
    check_spans(levels, "4K optimize_pair, again", 0)
    require(torch.equal(got.v, want.v) and all(map(same_level_stats, got.level_stats, want.level_stats)),
            "4K optimize_pair: the replays differ from the eager loop")
    log(f"  4K optimize_pair, {len(got.level_stats)} levels: bitwise the eager loop; eager {t_e:.3f} s, first "
        f"(captures) {t_first:.3f} s, replayed {t_g:.3f} s; peak {peak / 2**30:.2f} GiB above the inputs, "
        f"{kept / 2**30:.2f} GiB kept by the levels' graphs and buffers on {card}")
    descent._graphs.clear()
    torch.cuda.empty_cache()
    return read_counters(counters)


def flow_sweep_inputs(h: int, w: int, nb: int, dev, seed: int) -> dict:
    """Kernel 5's inputs at (h, w, nb) on ``dev``: flows of a few pixels,
    data terms of the grey images' scale, ``denom`` as the level makes it."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=g).to(dev)
    ix, iy = 20.0 * r(h, w, nb), 20.0 * r(h, w, nb)
    alpha2 = 15.0 * 15.0
    return dict(ut=3.0 * r(h, w, nb, 2), u_w=3.0 * r(h, w, nb, 2), it=30.0 * r(h, w, nb), ix=ix, iy=iy,
                denom=alpha2 + ix * ix + iy * iy)


def flow_sweeps(dev, card: str) -> tuple:
    """Phase 23: kernel 5 against its plain version, bitwise, at
    ``FLOW_SWEEP_SHAPES``, timed at the first; then ``clip_flows`` of phase
    5's clip A against the same flows with every sweep eager, each level's
    ``fused_sweeps`` counter read. Returns the launches of the
    ``clip_flows`` runs (the checks and the timing left out) and kernel 5's
    record."""
    import torch

    from videomorphing_tpu_torch.config import VideoParams
    from videomorphing_tpu_torch.kernels import flow as kf
    from videomorphing_tpu_torch.utils import profiling
    from videomorphing_tpu_torch.utils.synthetic import make_clips
    from videomorphing_tpu_torch.video import flow as tf

    rec = {"max_abs_err": 0.0, "library_ms": None}
    for k, (h, w, nb) in enumerate(FLOW_SWEEP_SHAPES):
        x = flow_sweep_inputs(h, w, nb, dev, seed=k)
        args = (x["u_w"], x["it"], x["ix"], x["iy"], x["denom"])
        bufs = (torch.empty_like(x["ut"]), torch.empty_like(x["ut"]))
        one = kf.hs_sweep(x["ut"], *args, bufs[0])
        require(torch.equal(one, kf.hs_sweep_plain(x["ut"], *args)), f"hs_sweep {h}x{w}x{nb}: one sweep differs")
        got, ref = x["ut"], x["ut"]
        for i in range(8):
            got = kf.hs_sweep(got, *args, bufs[i % 2])
            ref = kf.hs_sweep_plain(ref, *args)
        err = float((got - ref).abs().max())
        log(f"  hs_sweep {h}x{w}x{nb}: one sweep and 8 chained bitwise the plain version "
            f"(max |ut| {float(got.abs().max()):.3f} px)")
        require(torch.equal(got, ref), f"hs_sweep {h}x{w}x{nb}: 8 sweeps differ by {err}")
        if k == 0:
            n = h * w * nb
            rec["bound"] = bound(FLOW_SWEEP_BYTES * n, FLOW_SWEEP_OPS * n)
            kern = lambda: kf.hs_sweep(x["ut"], *args, bufs[0])
            plain = lambda: kf.hs_sweep_plain(x["ut"], *args)
            rec["ms"], rec["plain_ms"], (k1, k2, pl1, pl2), call = timed_pair(kern, plain)
            b_ms, b_by = rec["bound"]
            share = b_ms / rec["ms"]
            log(f"  hs_sweep {h}x{w}x{nb} time: kernel {k1:.4f}/{k2:.4f} ms (device), {call:.4f} ms (call), "
                f"plain {pl1:.4f}/{pl2:.4f} ms; bound {b_ms:.4f} ms ({b_by}), {100 * share:.1f} % of it, "
                f"{FLOW_SWEEP_BYTES * n / (rec['ms'] * 1e-3) / 1e12:.3f} TB/s on {card}")
            require(share >= FLOW_SWEEP_MIN_SHARE,
                    f"hs_sweep at {100 * share:.1f} % of its bound, under {100 * FLOW_SWEEP_MIN_SHARE:.0f} %")
        del x, args, bufs, one, got, ref
    torch.cuda.empty_cache()

    vp = VideoParams()
    t_len, h, w = 30, 1080, 1920
    clip = torch.from_numpy(make_clips(t_len, h, w, seed=0)[0]).to(dev)

    def eager_sweep(ut, u_w, it, ix, iy, denom, out):
        return out.copy_(kf.hs_sweep_plain(ut, u_w, it, ix, iy, denom))

    eager_sweep.launches = 0
    fused_sweep = kf.hs_sweep

    def timed_flows():
        sync(dev)
        t0 = time.perf_counter()
        fwd, bwd = tf.clip_flows(clip, vp)
        sync(dev)
        return fwd, bwd, time.perf_counter() - t0

    counters = reset_counters()
    profiling.clear()
    with profiling.record_phases():
        tf.clip_flows(clip, vp)  # warm-up
    levels = [s for s in profiling.spans() if s.name == "flow.level"]
    profiling.clear()
    require(levels and all(s.counts.get("fused_sweeps") == s.attrs["sweeps"] for s in levels),
            "flow.level spans without one fused_sweeps count a sweep: "
            + str([(s.attrs["h"], s.attrs["sweeps"], s.counts.get("fused_sweeps")) for s in levels]))
    before = kf.hs_sweep.launches
    fwd, bwd, wall = timed_flows()
    n_levels = len(tf._gray_pyramid(clip[:1].permute(1, 2, 0, 3), vp))
    fused = kf.hs_sweep.launches - before
    require(fused == n_levels * vp.flow_warps * vp.flow_iters, f"{fused} sweep launches for {n_levels} levels")
    kf.hs_sweep = eager_sweep
    try:
        tf.clip_flows(clip, vp)
        e_fwd, e_bwd, e_wall = timed_flows()
    finally:
        kf.hs_sweep = fused_sweep
    require(torch.equal(fwd, e_fwd) and torch.equal(bwd, e_bwd),
            f"clip_flows differs from its eager sweeps by {float((fwd - e_fwd).abs().max())} px")
    log(f"  clip_flows {t_len}x{h}x{w}: bitwise the eager sweeps; {fused} sweep launches ({n_levels} levels, "
        f"each level's fused_sweeps its sweeps), wall {wall:.3f} s, eager sweeps {e_wall:.3f} s, on {card}")
    launches = read_counters(counters)
    del clip, fwd, bwd, e_fwd, e_bwd
    torch.cuda.empty_cache()
    return launches, rec


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from videomorphing_tpu_torch.device import require_cuda
    from videomorphing_tpu_torch.kernels import build

    kernels_only = "--kernels" in argv
    t_start = time.perf_counter()
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
    lib = build.load()
    from videomorphing_tpu_torch.kernels import sweep as ks
    info = (ctypes.c_int * 6)()
    for bf16 in (0, 1):
        for with_grad in (1, 0):
            # every instantiation (R = 0 too), the wide strip at its first radius, R = 16 and its reach,
            # then the per-pixel chain (its kernels' extremes) past the reach
            radii = [r for r in range(0, 16) if ks.tiled(with_grad, r)]
            reach = max(r for r in range(64) if ks.wide_strip(with_grad, r))
            for r in radii + [radii[-1] + 1, 16, reach, reach + 1]:
                build.check(lib.vm_sweep_kernel_info(r, with_grad, bf16, info), "vm_sweep_kernel_info")
                what = ks.kernel_name(with_grad, r) + (" (bf16)" if bf16 else "")
                log(f"  {what}: {info[0]} registers, {info[1]} B static + {info[2]} B dynamic shared memory, "
                    f"{info[3]} B local, {info[4]} resident blocks of "
                    f"{info[5]} threads per SM ({info[4] * info[5] // 32} warps)")
                require(info[4] >= 1, f"{what} cannot be resident on an SM")
    for with_grad in (True, False):
        radii = [r for r in range(0, 11) if ks.tiled(with_grad, r)]
        reach = max(r for r in range(64) if ks.wide_strip(with_grad, r))
        for r in radii + [radii[-1] + 1, 10, 16, reach, reach + 1]:
            for w, nown in ((1024, 1024), (1920, 1080), (241, 135), (3840, 540), (30, 17), (1, 1)):
                got, sized = lib.vm_sweep_n_partials(w, nown, int(with_grad), r), ks.n_partials(w, nown, with_grad, r)
                require(got == sized,
                        f"partials of {nown}x{w} (with_grad={with_grad}, R = {r}): {got} on the card, {sized} sized")
        log(f"  {'gradient' if with_grad else 'energy'} tiles (rows, columns) by radius: "
            + ", ".join(f"R = {r}: {ks.sweep_tile(with_grad, r)}" for r in radii + [radii[-1] + 1, reach + 1])
            + "; partials counts agree with vm_sweep_n_partials")

    log("phase 2: kernels against their plain versions")
    rec = check_kernels(dev)

    if kernels_only:
        log(json.dumps(rec))
        return 0
    log("phase 3: pair path (api.morph_pair, 1024x1024, 4 points, 16 frames)")
    launches = main_path(dev, card)
    log("phase 4: golden cases (utils.golden.run_golden: translation, rotation, scale)")
    golden_launches = golden(dev)
    log("phase 5: video path (api.morph_clips, 30 frames of 1080x1920, 4 points)")
    video_launches = video_path(dev, card)
    log("phase 6: determinism")
    determinism(dev)
    log("phase 7: layered pair path (api.morph_pair_layered, 1024x1024, 1 layer, 4 points, 16 frames)")
    layered_launches = layered_pair_path(dev, card)
    log("phase 8: layered video path (api.morph_clips_layered, 30 frames of 1080x1920, 1 layer, 4 points)")
    layered_video_launches = layered_video_path(dev, card)
    log("phase 9: command line (cli video with a field store, twice; cli project, layered)")
    command_line()
    log("phase 10: spatial pair (optimize_pair_spatial, 2160x3840, 4 row blocks of one card, 16 frames)")
    spatial_launches = spatial_path(dev, card)
    log("phase 11: mesh video path (api.morph_clips, 30 frames of 1080x1920, a 3-device mesh of one card)")
    mesh_launches = mesh_video_path(dev, card)
    log("phase 12: manifest (parallel.batch.run_manifest, 3 jobs of {}x{}, a 2-device mesh of one card)".format(
        *MANIFEST_HW))
    manifest_launches = manifest_path(dev, card)
    log("phase 13: streamed clip pair (StreamingBatchRunner, {} frames of {}x{} through the native reader), "
        "cli batch".format(*STREAM_THW))
    stream_launches = stream_path(dev, card)
    batch_command_line(dev)
    log("phase 14: stressor (utils.stressor: the gate at {}x{}x{}, metrics at {}x{}x{})".format(
        *STRESSOR_GATE_THW, *STRESSOR_FULL_THW))
    stressor_launches = stressor_path(dev, card)
    log(f"phase 15: edit session (edit.PointEditor, {EDIT_N}x{EDIT_N}, 4 + 1 points, cold and warm solves, "
        "preview, cursor, 16-frame render)")
    edit_launches = edit_session(dev, card)
    log("phase 16: pairs x rows (make_spatial_level_solver(batch_axis='batch'), 4 pairs of {}x{}, "
        "a (2, {}) mesh of one card)".format(*PAIRS_ROWS_HW, PAIRS_ROWS_BLOCKS))
    rows_launches = pairs_by_rows(dev, card)
    log("phase 17: examples (demo_pair_torch, demo_video_torch compute functions)")
    examples_launches = examples_path(dev, card)
    log(f"phase 18: wide windows (api.morph_pair at ssim_window {WIDE_PAIR_WINDOW} and {WIDE_PAIR_WINDOWS}, "
        f"run_golden at {WIDE_PAIR_WINDOW}, optimize_pair_spatial at {SPATIAL_HW[0]}x{SPATIAL_HW[1]} on 4 row blocks "
        f"at ssim_window {WIDE_SPATIAL_WINDOWS})")
    wide_launches = wide_windows(dev, card)
    log("phase 19: bf16 pack (pack_dtype='bfloat16': api.morph_pair 1024x1024, api.morph_clips {}x{}x{}, "
        "optimize_pair_spatial {}x{} on 4 row blocks, run_golden)".format(*BF16_VIDEO_THW, *SPATIAL_HW))
    bf16_launches = bf16_pack(dev, card)
    log("phase 20: bench (cli bench: video_1080p, 3 repeats, in a child process; bench.main for {}, "
        "then kernels)".format(", ".join(BENCH_PATH_CONFIGS)))
    bench_launches = bench_path(dev, card)
    log("phase 21: render graphs (synth.render.render_frame replayed against its eager body, 1024x1024 and "
        "1080x1920, cache clears, a TF32 flip)")
    graph_launches = render_graphs(dev, card)
    log("phase 22: solver graphs (make_level_solver replayed against its eager loop at 64^2 to 2160x3840, "
        "optimize_pair, the video's warm solve, the 4K pyramid's memory)")
    solver_graph_launches = solver_graphs(dev, card)
    log("phase 23: flow sweeps (kernels.flow.hs_sweep against its plain version at clip30's levels, timed at "
        "540x960x58; clip_flows against its eager sweeps)")
    flow_launches, rec["hs_sweep"] = flow_sweeps(dev, card)

    paths = (launches, golden_launches, video_launches, layered_launches, layered_video_launches, spatial_launches,
             mesh_launches, manifest_launches, stream_launches, stressor_launches, edit_launches, rows_launches,
             examples_launches, wide_launches, bf16_launches, bench_launches, graph_launches,
             solver_graph_launches, flow_launches)
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = rec[name]
        bound_ms, bound_by = r["bound"]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(ph[name] for ph in paths), "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": r["library_ms"],
        })
    log("launches in phase 19 (bf16 pack): " + json.dumps(bf16_launches))
    log(f"script: {time.perf_counter() - t_start:.1f} s, the build included")
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
