"""Command-line interface of the port: ``vmorph-torch pair | video | project | batch | import``.

Port of ``videomorphing_tpu/cli.py``. Every run emits the metrics
(frames/s, optimizer iterations/s/Mpixel, endpoint and halfway-agreement
SSIM) as JSON lines with ``-v``, so every run is a benchmark run.
``--device`` (default ``cuda``) says where the work runs; without a card
the CUDA device raises, it does not fall back to the CPU.

    python -m videomorphing_tpu_torch.cli pair a.png b.png --points pts.json \\
        --frames 16 --out out_dir
    python -m videomorphing_tpu_torch.cli video a.vmc b.vmc --points p.json \\
        --out m.vmc --fields f.npz -v
    python -m videomorphing_tpu_torch.cli project job.json
    python -m videomorphing_tpu_torch.cli batch --manifest jobs.json
    python -m videomorphing_tpu_torch.cli batch --clip-a a.vmc --clip-b b.vmc --out out.vmc

``pair --spatial-shards N`` solves one large frame with its rows split
over ``min(N, devices)`` devices (``parallel.spatial``; the devices are the
cards for ``--device cuda``, one for the CPU), ``video`` splits the clip
over every card when there is more than one, and ``batch`` spreads its
pairs over the same devices (``parallel.batch``). ``edit`` and ``bench``
are not ported yet (ROADMAP queue 1 items 6 and 2).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from videomorphing_tpu_torch.config import MorphParams, SynthParams, VideoParams
from videomorphing_tpu_torch.device import as_device, require_cuda
from videomorphing_tpu_torch.io.clips import load_clip, save_clip
from videomorphing_tpu_torch.io.images import load_image, to_float
from videomorphing_tpu_torch.io.project import Project, load_project
from videomorphing_tpu_torch.utils.checkpoint import FieldStore
from videomorphing_tpu_torch.utils.logging import (
    MetricsLogger,
    endpoint_ssim,
    level_record,
    midpoint_agreement_ssim,
)


def _load_points(path: Optional[str]):
    """Points JSON: ``[[..],..]`` / ``{"points": [..]}`` for one frame, or
    ``{"keyframes": {"0": [..], "12": [..]}}`` for keyframed video points."""
    if not path:
        return None
    with open(path) as f:
        d = json.load(f)
    if isinstance(d, dict) and "keyframes" in d:
        return {int(k): np.asarray(v, np.float32) for k, v in d["keyframes"].items()}
    return np.asarray(d["points"] if isinstance(d, dict) else d, np.float32)


def _add_param_overrides(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--lambda-tps", type=float, default=None)
    ap.add_argument("--gamma-ui", type=float, default=None)
    ap.add_argument("--beta-tc", type=float, default=None)
    ap.add_argument("--levels", type=int, default=None)
    ap.add_argument("--iters", type=int, default=None, help="iters at coarsest level")
    ap.add_argument("--blend", choices=["linear", "poisson"], default=None)
    ap.add_argument("--no-quadratic-paths", action="store_true")
    ap.add_argument("--sampling", choices=["bilinear", "bicubic"], default=None,
                    help="final color-sampling interpolant (bicubic = sharper, "
                         "plain PyTorch, no kernel)")
    ap.add_argument("--flow-robust", action="store_true",
                    help="Brox-class robust optical flow: structure-texture "
                         "prefilter + Charbonnier + gradient constancy + TV "
                         "(survives lighting drift; ~3x flow cost)")
    ap.add_argument("--set", action="append", default=[], metavar="SEC.KEY=VAL",
                    help="generic config override, e.g. --set morph.ssim_window=7 "
                         "--set video.flow_gamma=20 (sections: morph/synth/video; "
                         "repeatable; same fields as the project JSON)")
    _add_runtime_flags(ap)
    ap.add_argument("--verbose", "-v", action="store_true")
    ap.add_argument("--trace", default=None, metavar="LOGDIR",
                    help="write a torch.profiler Chrome trace (trace.json) of the solve")


def _add_runtime_flags(ap: argparse.ArgumentParser) -> None:
    """Flags every subcommand needs."""
    ap.add_argument("--fps", type=int, default=30,
                    help="frame rate stamped into .y4m video outputs")
    ap.add_argument("--device", default="cuda", metavar="cuda|cpu",
                    help="where the morph runs (default cuda; raises when there "
                         "is no CUDA device)")


def _apply_set_overrides(sets, mp, sp, vp):
    """Apply ``--set section.field=value`` strings; values parse as JSON
    first (numbers/bools), falling back to raw string. Unknown sections or
    fields raise with the valid choices listed."""
    secs = {"morph": mp, "synth": sp, "video": vp}
    for item in sets:
        try:
            key, val = item.split("=", 1)
            sec, field = key.split(".", 1)
        except ValueError:
            raise SystemExit(f"--set expects SECTION.FIELD=VALUE, got {item!r}")
        if sec not in secs:
            raise SystemExit(f"--set section must be one of {sorted(secs)}, got {sec!r}")
        cfg = secs[sec]
        if not hasattr(cfg, field):
            names = [f.name for f in dataclasses.fields(cfg)]
            raise SystemExit(f"{sec} has no field {field!r}; valid: {names}")
        try:
            parsed = json.loads(val)
        except json.JSONDecodeError:
            low = val.strip().lower()
            # the common boolean spellings beyond JSON's true/false; anything
            # else stays a string (bool("False") is True)
            if low in ("true", "yes", "on"):
                parsed = True
            elif low in ("false", "no", "off"):
                parsed = False
            else:
                parsed = val
        cur = getattr(cfg, field)
        if isinstance(cur, bool):
            if not isinstance(parsed, bool):
                raise SystemExit(
                    f"--set {sec}.{field} expects a boolean, got {val!r} "
                    "(use true/false)"
                )
        elif isinstance(cur, int) and cur is not None:
            if isinstance(parsed, str) or (
                isinstance(parsed, float) and parsed != int(parsed)
            ):
                raise SystemExit(f"--set {sec}.{field} expects an int, got {val!r}")
            if isinstance(parsed, (int, float)):
                parsed = int(parsed)
        elif isinstance(cur, float):
            if isinstance(parsed, str):
                raise SystemExit(f"--set {sec}.{field} expects a number, got {val!r}")
            if isinstance(parsed, (int, float)):
                parsed = float(parsed)
        secs[sec] = dataclasses.replace(cfg, **{field: parsed})
    return secs["morph"], secs["synth"], secs["video"]


def _params_from_args(args) -> tuple[MorphParams, SynthParams, VideoParams]:
    mp = MorphParams()
    if args.lambda_tps is not None:
        mp = dataclasses.replace(mp, lambda_tps=args.lambda_tps)
    if args.gamma_ui is not None:
        mp = dataclasses.replace(mp, gamma_ui=args.gamma_ui)
    if getattr(args, "beta_tc", None) is not None:
        mp = dataclasses.replace(mp, beta_tc=args.beta_tc)
    if args.levels is not None:
        mp = dataclasses.replace(mp, n_levels=args.levels)
    if args.iters is not None:
        mp = dataclasses.replace(mp, iters_coarse=args.iters)
    sp = SynthParams()
    if args.blend is not None:
        sp = dataclasses.replace(sp, blend_mode=args.blend)
    if args.no_quadratic_paths:
        sp = dataclasses.replace(sp, quadratic_paths=False)
    if getattr(args, "sampling", None) is not None:
        sp = dataclasses.replace(sp, sampling=args.sampling)
    vp = VideoParams()
    if getattr(args, "flow_robust", False):
        vp = dataclasses.replace(vp, flow_robust=True)
    return _apply_set_overrides(getattr(args, "set", []), mp, sp, vp)


def _device(args) -> torch.device:
    """``--device`` resolved; a CUDA device without a card raises."""
    dev = torch.device(args.device)
    if dev.type == "cuda":
        require_cuda()
    return as_device(dev)


def _devices_of(dev: torch.device) -> list:
    """The devices a mesh may span for ``--device``: every card, or the CPU."""
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def cmd_pair(args) -> int:
    from videomorphing_tpu_torch import api
    from videomorphing_tpu_torch.models.image_morph import ImageMorpher
    from videomorphing_tpu_torch.ops.pyramid import pyramid_shapes
    from videomorphing_tpu_torch.utils.profiling import trace_to
    from videomorphing_tpu_torch.video.pipeline import _default_times

    dev = _device(args)
    m = MetricsLogger(verbose=args.verbose)
    mp, sp, _ = _params_from_args(args)
    i0 = api._dev(load_image(args.image_a), dev)
    i1 = api._dev(load_image(args.image_b), dev)
    points = _load_points(args.points)

    t0 = time.perf_counter()
    with trace_to(args.trace), m.phase("solve"):
        if args.spatial_shards > 1:
            # one large frame's rows across devices (config 5's spatial tier)
            from videomorphing_tpu_torch.models.image_morph import MorphArtifacts
            from videomorphing_tpu_torch.parallel.mesh import make_mesh
            from videomorphing_tpu_torch.parallel.spatial import optimize_pair_spatial
            from videomorphing_tpu_torch.synth.paths import bulge_field

            devices = _devices_of(dev)
            n = min(args.spatial_shards, len(devices))
            mesh = make_mesh((n,), ("y",), devices=devices)
            res = optimize_pair_spatial(i0, i1, api._pts(points, dev), mp, mesh)
            b = bulge_field(res.v, sp) if sp.quadratic_paths else None
            art = MorphArtifacts(v=res.v, b=b, result=res)
            m.emit("spatial", shards=n)
        else:
            art = api.solve_pair(i0, i1, points, mp, sp, device=dev)
        _sync(dev)
    shapes = pyramid_shapes(i0.shape[0], i0.shape[1], art.result.n_levels)
    # level_stats run coarse -> fine; entry k solved level (n_solved - 1 - k)
    n_solved = len(art.result.level_stats)
    for li, st in enumerate(art.result.level_stats):
        m.emit("level", **level_record(li, shapes[n_solved - 1 - li], st))
    with m.phase("render"):
        frames = ImageMorpher(mp, sp, str(dev)).render(i0, i1, art, _default_times(args.frames, "cpu"))
        _sync(dev)
    dt = time.perf_counter() - t0

    h, w = i0.shape[:2]
    total_iters = sum(int(s.iters) for s in art.result.level_stats)
    m.emit(
        "metrics",
        frames_per_sec=args.frames / dt,
        iters_per_sec_per_mpix=total_iters / dt / (h * w / 1e6),
        wall_seconds=dt,
        **endpoint_ssim(frames, i0, i1),
        **midpoint_agreement_ssim(art.v, i0, i1),
    )
    save_clip(args.out, _numpy(frames), fps=args.fps)
    print(f"wrote {args.frames} frames to {args.out} in {dt:.2f}s")
    return 0


def cmd_video(args) -> int:
    from videomorphing_tpu_torch import api
    from videomorphing_tpu_torch.utils.profiling import trace_to
    from videomorphing_tpu_torch.video.pipeline import render_video, resume_clip_fields

    dev = _device(args)
    m = MetricsLogger(verbose=args.verbose)
    mp, sp, vp = _params_from_args(args)
    clip_a = api._dev(load_clip(args.clip_a), dev)
    clip_b = api._dev(load_clip(args.clip_b), dev)
    points = api._pts(_load_points(args.points), dev)
    t_len, h, w = clip_a.shape[:3]

    store = FieldStore(args.fields) if args.fields else None
    done_n = 0
    if store is not None and store.done.shape == (t_len,):
        # resume only from fields of this clip's resolution: a store saved at
        # another size with the same frame count would feed wrong-scale
        # fields into the render
        v_stored = store.fields()[0]
        if v_stored is not None and v_stored.shape[1:3] == (h, w):
            done_n = store.first_pending()
        else:
            m.emit(
                "resume_skipped",
                reason="field store resolution mismatch",
                stored=list(v_stored.shape[1:3]) if v_stored is not None else None,
                clip=[h, w],
            )

    # frames split over every card when there is more than one (the
    # reference's config-4 layout): frame blocks in the solve, frames in
    # the render
    mesh = None
    devices = _devices_of(dev)
    if len(devices) > 1 and t_len > 1:
        from videomorphing_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(devices=devices)

    t0 = time.perf_counter()
    with trace_to(args.trace), m.phase("video"):
        if done_n == t_len:
            # all fields stored: re-render without re-optimizing
            v_all, b_all = store.fields()
            res = render_video(
                clip_a, clip_b, api._dev(v_all, dev), sp=sp, vp=vp,
                bulges=api._dev(b_all, dev) if sp.quadratic_paths else None, mesh=mesh,
            )
            m.emit("resume", skipped_frames=t_len)
        elif done_n > 0:
            # continue the warm loop at the first pending frame
            v_all, _ = store.fields()
            vs = resume_clip_fields(clip_a, clip_b, v_all[done_n - 1], done_n, points, mp, vp)
            fields = torch.cat([api._dev(v_all[:done_n], dev), vs], 0)
            res = render_video(clip_a, clip_b, fields, sp=sp, vp=vp, mesh=mesh)
            m.emit("resume", skipped_frames=done_n)
        else:
            res = api.morph_clips(clip_a, clip_b, points, mp=mp, sp=sp, vp=vp, mesh=mesh, device=dev)
        _sync(dev)
    dt = time.perf_counter() - t0

    if store is not None:
        store.init(t_len, h, w)
        bulges = None if res.bulges is None else _numpy(res.bulges)
        store.put(np.arange(t_len), _numpy(res.fields), bulges)
        store.save()

    mid = t_len // 2
    m.emit(
        "metrics",
        frames_per_sec=t_len / dt,
        wall_seconds=dt,
        resolution=f"{h}x{w}",
        **endpoint_ssim(res.frames, clip_a[0], clip_b[-1]),
        **midpoint_agreement_ssim(res.fields[mid], clip_a[mid], clip_b[mid]),
    )
    save_clip(args.out, _numpy(res.frames), fps=args.fps)
    print(f"wrote {t_len} morph frames ({h}x{w}) to {args.out} in {dt:.2f}s")
    return 0


def cmd_import(args) -> int:
    """Convert a reference-style XML project to the JSON schema, with a
    coverage report (the XML schema is best effort; see io/project_xml.py)."""
    from videomorphing_tpu_torch.io.project import save_project
    from videomorphing_tpu_torch.io.project_xml import import_xml_project

    proj, report = import_xml_project(args.project)
    out = args.out or os.path.splitext(args.project)[0] + ".json"
    save_project(out, proj)
    for line in report["mapped"]:
        print(f"  mapped : {line}")
    for line in report["skipped"]:
        print(f"  SKIPPED: {line}")
    print(f"wrote {out} ({len(report['mapped'])} mapped, "
          f"{len(report['skipped'])} skipped — review before running)")
    return 0


def cmd_project(args) -> int:
    if args.project.lower().endswith(".xml"):
        from videomorphing_tpu_torch.io.project_xml import import_xml_project

        proj, report = import_xml_project(args.project)
        for line in report["skipped"]:
            print(f"xml import SKIPPED: {line}", file=sys.stderr)
    else:
        proj = load_project(args.project)
    dev = _device(args)
    is_clip = not proj.source_a.lower().endswith((".png", ".jpg", ".jpeg", ".bmp"))
    if is_clip:
        return _run_project_video(proj, dev, args.fps)
    return _run_project_pair(proj, dev, args.fps)


def _layer_dicts(proj: Project, load_mask):
    return [
        dict(
            mask0=load_mask(l["mask_a"]),
            mask1=load_mask(l["mask_b"]),
            points=np.asarray(l["points"], np.float32) if l.get("points") else None,
        )
        for l in proj.layers
    ]


def _run_project_pair(proj: Project, dev: torch.device, fps: int) -> int:
    from videomorphing_tpu_torch import api
    from videomorphing_tpu_torch.models.image_morph import ImageMorpher
    from videomorphing_tpu_torch.video.pipeline import _default_times

    i0 = api._dev(load_image(proj.source_a), dev)
    i1 = api._dev(load_image(proj.source_b), dev)
    t0 = time.perf_counter()
    if proj.layers:
        layers = _layer_dicts(proj, lambda p: load_image(p).mean(-1))
        frames = api.morph_pair_layered(
            i0, i1, layers, proj.points, proj.n_frames, proj.morph, proj.synth, device=dev
        )
        save_clip(proj.output, _numpy(frames), fps=fps)
        print(f"wrote {frames.shape[0]} layered frames to {proj.output} "
              f"in {time.perf_counter() - t0:.2f}s")
        return 0
    art = api.solve_pair(i0, i1, proj.points, proj.morph, proj.synth, device=dev)
    ts = proj.times if proj.times is not None else _default_times(proj.n_frames, "cpu")
    frames = ImageMorpher(proj.morph, proj.synth, str(dev)).render(i0, i1, art, ts)
    save_clip(proj.output, _numpy(frames), fps=fps)
    print(f"wrote {frames.shape[0]} frames to {proj.output} in {time.perf_counter() - t0:.2f}s")
    return 0


def _load_mask(path: str) -> np.ndarray:
    """Layer mask: a single image (static, broadcast over time) or a clip
    (per-frame masks); reduced to one channel in [0, 1]."""
    if path.lower().endswith((".png", ".jpg", ".jpeg")):
        return load_image(path).mean(-1)
    m = load_clip(path)
    return m.mean(-1) if m.ndim == 4 else m


def _run_project_video(proj: Project, dev: torch.device, fps: int) -> int:
    from videomorphing_tpu_torch import api

    clip_a = api._dev(load_clip(proj.source_a), dev)
    clip_b = api._dev(load_clip(proj.source_b), dev)
    t0 = time.perf_counter()
    if proj.layers:
        # layered clips: per-layer temporally propagated fields
        res = api.morph_clips_layered(
            clip_a, clip_b, _layer_dicts(proj, _load_mask), proj.points,
            times=proj.times, mp=proj.morph, sp=proj.synth, vp=proj.video, device=dev,
        )
    else:
        res = api.morph_clips(
            clip_a, clip_b, proj.points,
            times=proj.times, mp=proj.morph, sp=proj.synth, vp=proj.video, device=dev,
        )
    save_clip(proj.output, _numpy(res.frames), fps=fps)
    print(f"wrote {clip_a.shape[0]} frames to {proj.output} in {time.perf_counter() - t0:.2f}s")
    return 0


def _load_still(path: str) -> np.ndarray:
    """A manifest job's image: ``.npy`` (float in [0, 1] or uint8) without
    PIL, any other format through ``load_image``."""
    if path.endswith(".npy"):
        return to_float(np.load(path))
    return load_image(path)


def cmd_batch(args) -> int:
    """Config-5 batch pipeline (BASELINE.json config 5).

    - ``--manifest jobs.json``: many independent image-pair jobs, solved in
      mesh-sized blocks spread over the devices of ``--device``;
    - ``--clip-a A --clip-b B --out out.vmc``: two clips streamed pair by
      pair (decode -> H2D -> solve/render -> D2H -> encode, overlapped);
      every frame pair solves alone.

    ``--multihost`` joins a process group from the reference's
    ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``
    (``parallel.multihost``) and takes this process's share of the manifest.
    """
    from videomorphing_tpu_torch.io.clips import VmcWriter, open_clip_reader, read_vmc_header
    from videomorphing_tpu_torch.parallel import batch as pbatch
    from videomorphing_tpu_torch.parallel.mesh import make_mesh

    dev = _device(args)
    m = MetricsLogger(verbose=args.verbose)
    mp, sp, _ = _params_from_args(args)
    if args.multihost:
        from videomorphing_tpu_torch.parallel.multihost import initialize

        pid, n_proc = initialize(device=dev)
    mesh = make_mesh(devices=_devices_of(dev))  # this process's devices (multihost.global_mesh)
    bsz = int(mesh.shape["batch"])

    if args.manifest:
        with open(args.manifest) as f:
            spec = json.load(f)
        job_specs = spec["jobs"] if isinstance(spec, dict) else spec
        if args.multihost:
            from videomorphing_tpu_torch.parallel.multihost import process_shard

            job_specs = process_shard(job_specs)
            m.emit("multihost", process=pid, n_processes=n_proc, jobs=len(job_specs))
        jobs = []
        for j in job_specs:
            pts = j.get("points")
            if isinstance(pts, str):
                pts = _load_points(pts)
            elif pts is not None:
                pts = np.asarray(pts, np.float32)
            jobs.append(dict(i0=_load_still(j["a"]), i1=_load_still(j["b"]), points=pts,
                             n_frames=int(j.get("n_frames", args.frames))))
        t0 = time.perf_counter()
        results = pbatch.run_manifest(jobs, mesh, mp, sp, verbose=args.verbose)
        dt = time.perf_counter() - t0
        n_frames_total = 0
        for j, frames in zip(job_specs, results):
            out = j.get("out") or f"{os.path.splitext(j['a'])[0]}_morph"
            save_clip(out, frames, fps=args.fps)
            n_frames_total += frames.shape[0]
        m.emit("metrics", jobs=len(jobs), frames_per_sec=n_frames_total / dt, wall_seconds=dt)
        print(f"ran {len(jobs)} jobs ({n_frames_total} frames) in {dt:.2f}s")
        return 0

    if not (args.clip_a and args.clip_b):
        print("batch: need --manifest or --clip-a/--clip-b", file=sys.stderr)
        return 2
    if args.clip_a.endswith(".vmc"):
        t_len, h, w, _c = read_vmc_header(args.clip_a)
    elif args.clip_a.endswith(".y4m"):
        # header only: decoding the clip to learn its shape would defeat the streaming
        from videomorphing_tpu_torch.io.y4m import read_y4m_header

        t_len, h, w, _chroma, _fps = read_y4m_header(args.clip_a)
    else:
        t_len, h, w = load_clip(args.clip_a).shape[:3]
    points = _load_points(args.points)
    runner = pbatch.StreamingBatchRunner(mesh, mp, sp)
    t0 = time.perf_counter()
    n_done = 0
    with VmcWriter(args.out) as wr:
        for _s, frames in runner.run_clip_pair(
            open_clip_reader(args.clip_a, block=bsz),
            open_clip_reader(args.clip_b, block=bsz),
            t_len, (h, w), points=points,
        ):
            wr.append(frames)
            n_done += frames.shape[0]
    dt = time.perf_counter() - t0
    m.emit("metrics", frames_per_sec=n_done / dt, wall_seconds=dt, resolution=f"{h}x{w}")
    print(f"wrote {n_done} morph frames ({h}x{w}) to {args.out} in {dt:.2f}s")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="vmorph-torch", description="halfway-domain image/video morphing on PyTorch and CUDA"
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_pair = sub.add_parser("pair", help="morph an image pair")
    p_pair.add_argument("image_a")
    p_pair.add_argument("image_b")
    p_pair.add_argument("--points", default=None, help="JSON file with [[y0,x0],[y1,x1]] pairs")
    p_pair.add_argument("--frames", type=int, default=16)
    p_pair.add_argument("--out", default="morph_out")
    p_pair.add_argument(
        "--spatial-shards", type=int, default=1,
        help="shard one large frame's rows over min(N, devices) devices",
    )
    _add_param_overrides(p_pair)
    p_pair.set_defaults(fn=cmd_pair)

    p_vid = sub.add_parser("video", help="morph a clip pair")
    p_vid.add_argument("clip_a", help="frame dir / .npz / .npy / .vmc / .y4m / video file")
    p_vid.add_argument("clip_b")
    p_vid.add_argument("--points", default=None)
    p_vid.add_argument("--out", default="morph_out.npz")
    p_vid.add_argument("--fields", default=None, help="field store .npz for resume/re-render")
    _add_param_overrides(p_vid)
    p_vid.set_defaults(fn=cmd_video)

    p_proj = sub.add_parser("project", help="run a project JSON (or import+run an .xml)")
    p_proj.add_argument("project")
    p_proj.add_argument("--verbose", "-v", action="store_true")
    _add_runtime_flags(p_proj)
    p_proj.set_defaults(fn=cmd_project)

    p_batch = sub.add_parser(
        "batch", help="config-5 batch pipeline (manifest of pair jobs / streamed clip pair)"
    )
    p_batch.add_argument("--manifest", default=None,
                         help="JSON: {jobs: [{a, b, points, n_frames, out}]} (a, b: images or .npy)")
    p_batch.add_argument("--clip-a", default=None)
    p_batch.add_argument("--clip-b", default=None)
    p_batch.add_argument("--points", default=None)
    p_batch.add_argument("--out", default="batch_out.vmc")
    p_batch.add_argument("--frames", type=int, default=16, help="default n_frames for manifest jobs")
    p_batch.add_argument(
        "--multihost", action="store_true",
        help="join a torch.distributed group (JAX_COORDINATOR_ADDRESS / "
             "JAX_NUM_PROCESSES / JAX_PROCESS_ID) and shard the manifest by process",
    )
    _add_param_overrides(p_batch)
    p_batch.set_defaults(fn=cmd_batch)

    p_imp = sub.add_parser(
        "import",
        help="convert a reference-style XML project to the JSON schema "
             "(best-effort; prints a mapped/skipped coverage report)",
    )
    p_imp.add_argument("project", help="path to the .xml project")
    p_imp.add_argument("--out", default=None, help="output .json (default: same name)")
    _add_runtime_flags(p_imp)
    p_imp.set_defaults(fn=cmd_import)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
