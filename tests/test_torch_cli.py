"""The port's command line: ``pair``, ``video``, ``project``, ``batch`` and ``import``
(``bench``: ``tests/test_torch_bench.py``).

- the same argv gives the same ``MorphParams``/``SynthParams``/
  ``VideoParams`` values through both packages' ``_params_from_args``, and
  the same ``--set`` errors;
- ``video`` with ``--device cpu`` on a 3 x 24 x 32 ``.npz`` pair writes
  exactly the frames of ``api.morph_clips`` on the same inputs (compared
  after the uint8 quantization of the output file), emits its metrics as
  JSON lines with ``-v``, and a second run (all fields stored) or a run
  from a partly filled field store resumes and writes bitwise the same
  file;
- ``endpoint_ssim`` and ``midpoint_agreement_ssim`` match the reference
  within 1e-5, one unit of the 5th decimal they are rounded to;
- ``pair`` (also with ``--spatial-shards``, clamped to one device on the
  CPU), ``project`` (a layered clip project and a layered image project)
  and ``import`` write what the library gives;
- ``batch --manifest`` (images as .png and .npy, ``--multihost`` as one
  process) and ``batch --clip-a/--clip-b`` (.vmc streams) write exactly
  the frames of ``parallel.batch.run_manifest`` / ``run_clip_pair`` on
  the same inputs (after the uint8 quantization of the output files);
- the default device, ``cuda``, raises without a card (no fallback).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
from videomorphing_tpu import cli as jcli
from videomorphing_tpu.utils import logging as jlog
from videomorphing_tpu_torch import api, cli
from videomorphing_tpu_torch.config import MorphParams, VideoParams
from videomorphing_tpu_torch.io import load_clip, load_project, save_image, to_uint8
from videomorphing_tpu_torch.models.image_morph import ImageMorpher
from videomorphing_tpu_torch.utils import logging as tlog
from videomorphing_tpu_torch.video.pipeline import _default_times

torch.set_num_threads(2)
T_LEN, H, W = 3, 24, 32
FAST = ["--iters", "8", "--set", "video.warm_iters_fine=4", "--set", "video.flow_iters=10"]
FAST_MP = MorphParams(iters_coarse=8)
FAST_VP = VideoParams(warm_iters_fine=4, flow_iters=10)


def _args(parser, argv):
    return parser.parse_args(argv)


@pytest.mark.parametrize(
    "argv",
    [
        ["pair", "a.png", "b.png"],
        ["pair", "a.png", "b.png", "--lambda-tps", "0.02", "--gamma-ui", "10", "--levels", "3",
         "--iters", "50", "--blend", "linear", "--no-quadratic-paths", "--sampling", "bicubic"],
        ["video", "a.vmc", "b.vmc", "--beta-tc", "0.7", "--flow-robust", "--set", "morph.ssim_window=7",
         "--set", "video.flow_gamma=20", "--set", "synth.occlusion_weighting=off",
         "--set", "morph.iters_fine=12.0", "--set", "video.warm_levels=2"],
    ],
)
def test_params_match_reference(argv):
    ref = jcli._params_from_args(_args(jcli.build_parser(), argv))
    got = cli._params_from_args(_args(cli.build_parser(), argv))
    for r, g in zip(ref, got):
        assert vars(g) == vars(r)


@pytest.mark.parametrize(
    "item",
    ["bogus.x=1", "morph.nope=1", "morph.iters_coarse=1.5", "synth.quadratic_paths=maybe",
     "morph.lambda_tps=abc", "noequals"],
)
def test_set_errors_match_reference(item):
    argv = ["video", "a.vmc", "b.vmc", "--set", item]
    with pytest.raises(SystemExit) as ref:
        jcli._params_from_args(_args(jcli.build_parser(), argv))
    with pytest.raises(SystemExit) as got:
        cli._params_from_args(_args(cli.build_parser(), argv))
    assert str(got.value) == str(ref.value)


def test_metrics_match_reference():
    rng = np.random.default_rng(6)
    frames = rng.random((3, 20, 28, 3), dtype=np.float32)
    a, b = rng.random((2, 20, 28, 3), dtype=np.float32)
    v = (1.5 * rng.standard_normal((20, 28, 2))).astype(np.float32)
    ref = {**jlog.endpoint_ssim(frames, a, b), **jlog.midpoint_agreement_ssim(v, a, b)}
    got = {**tlog.endpoint_ssim(torch.from_numpy(frames), a, b), **tlog.midpoint_agreement_ssim(v, a, b)}
    assert got.keys() == ref.keys()
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-5 + 1e-12, k


@pytest.fixture(scope="module")
def clip_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("clips")
    ca, cb = bench._make_clips(T_LEN, H, W, seed=0)
    np.savez(d / "a.npz", frames=ca)
    np.savez(d / "b.npz", frames=cb)
    pts = [[[H * 0.4, W * 0.45], [H * 0.4, W * 0.55]], [[H * 0.6, W * 0.45], [H * 0.6, W * 0.55]]]
    with open(d / "p.json", "w") as f:
        json.dump({"points": pts}, f)
    return d, ca, cb, np.asarray(pts, np.float32)


def _events(err: str):
    return [json.loads(line) for line in err.splitlines() if line.startswith("{")]


def test_video_writes_morph_clips_and_resumes(clip_files, tmp_path, capsys):
    d, ca, cb, pts = clip_files
    out, store = str(tmp_path / "out.vmc"), str(tmp_path / "store.npz")
    argv = ["video", str(d / "a.npz"), str(d / "b.npz"), "--points", str(d / "p.json"),
            "--fields", store, "--out", out, "-v", "--device", "cpu"] + FAST
    assert cli.main(argv) == 0
    events = _events(capsys.readouterr().err)
    metrics = [e for e in events if e["event"] == "metrics"][-1]
    for key in ("ssim_t0_vs_a", "ssim_t1_vs_b", "ssim_halfway_agreement", "frames_per_sec"):
        assert key in metrics
    ref = api.morph_clips(ca, cb, pts, mp=FAST_MP, vp=FAST_VP, device="cpu")
    first = open(out, "rb").read()
    np.testing.assert_array_equal(load_clip(out), to_uint8(ref.frames.numpy()) / np.float32(255.0))

    assert cli.main(argv) == 0
    resumed = [e for e in _events(capsys.readouterr().err) if e["event"] == "resume"]
    assert resumed and resumed[0]["skipped_frames"] == T_LEN
    assert open(out, "rb").read() == first

    # a store with only frame 0 done resumes the warm loop at frame 1
    with np.load(store) as z:
        v, b, done = z["v"], z["b"], z["done"]
    done[1:] = False
    np.savez_compressed(store, v=v, b=b, done=done)
    assert cli.main(argv) == 0
    resumed = [e for e in _events(capsys.readouterr().err) if e["event"] == "resume"]
    assert resumed and resumed[0]["skipped_frames"] == 1
    assert open(out, "rb").read() == first


def test_pair_writes_the_library_frames(tmp_path, capsys):
    clip_a, clip_b = bench._make_clips(1, H, W, seed=2)
    save_image(str(tmp_path / "a.png"), clip_a[0])
    save_image(str(tmp_path / "b.png"), clip_b[0])
    out = str(tmp_path / "m.vmc")
    assert cli.main(["pair", str(tmp_path / "a.png"), str(tmp_path / "b.png"), "--frames", "3",
                     "--out", out, "-v", "--device", "cpu", "--iters", "8"]) == 0
    levels = [e for e in _events(capsys.readouterr().err) if e["event"] == "level"]
    assert len(levels) == 1 and levels[0]["shape"] == [H, W]
    i0 = to_uint8(clip_a[0]) / np.float32(255.0)
    i1 = to_uint8(clip_b[0]) / np.float32(255.0)
    art = api.solve_pair(i0, i1, mp=FAST_MP, device="cpu")
    frames = ImageMorpher(FAST_MP, device="cpu").render(
        torch.from_numpy(i0), torch.from_numpy(i1), art, _default_times(3, "cpu")
    )
    np.testing.assert_array_equal(load_clip(out), to_uint8(frames.numpy()) / np.float32(255.0))
    # --spatial-shards clamps to the devices of --device (one for the CPU),
    # emits the spatial record and, with every level local, the same frames
    out2 = str(tmp_path / "m2.vmc")
    assert cli.main(["pair", str(tmp_path / "a.png"), str(tmp_path / "b.png"), "--frames", "3",
                     "--out", out2, "-v", "--device", "cpu", "--iters", "8", "--spatial-shards", "2"]) == 0
    spatial = [e for e in _events(capsys.readouterr().err) if e["event"] == "spatial"]
    assert len(spatial) == 1 and spatial[0]["shards"] == 1
    np.testing.assert_array_equal(load_clip(out2), load_clip(out))


def test_pair_spatial_shards_at_a_wide_window(tmp_path, capsys):
    """``pair --spatial-shards 2 --set morph.ssim_window=9`` runs and
    writes the frames of the same command without shards (on the CPU the
    shards clamp to one device, every level local)."""
    clip_a, clip_b = bench._make_clips(1, H, W, seed=2)
    save_image(str(tmp_path / "a.png"), clip_a[0])
    save_image(str(tmp_path / "b.png"), clip_b[0])
    base = ["pair", str(tmp_path / "a.png"), str(tmp_path / "b.png"), "--frames", "3", "-v", "--device", "cpu",
            "--iters", "8", "--set", "morph.ssim_window=9", "--set", "morph.ssim_sigma=1.5"]
    out, out2 = str(tmp_path / "m.vmc"), str(tmp_path / "m2.vmc")
    assert cli.main(base + ["--out", out2, "--spatial-shards", "2"]) == 0
    spatial = [e for e in _events(capsys.readouterr().err) if e["event"] == "spatial"]
    assert len(spatial) == 1 and spatial[0]["shards"] == 1
    frames = load_clip(out2)
    assert frames.shape == (3, H, W, 3) and np.isfinite(frames).all()
    assert cli.main(base + ["--out", out]) == 0
    np.testing.assert_array_equal(frames, load_clip(out))


def test_layered_clip_project(clip_files, tmp_path):
    d, ca, cb, pts = clip_files
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    m0 = np.stack([(np.hypot(yy - H / 2, xx - W * 0.45 - 2 * k) < 6).astype(np.float32) for k in range(T_LEN)])
    m1 = np.stack([(np.hypot(yy - H / 2, xx - W * 0.55 - 2 * k) < 6).astype(np.float32) for k in range(T_LEN)])
    np.save(tmp_path / "m0.npy", m0)
    np.save(tmp_path / "m1.npy", m1)
    proj = {
        "source_a": str(d / "a.npz"), "source_b": str(d / "b.npz"), "points": pts.tolist(),
        "layers": [{"mask_a": str(tmp_path / "m0.npy"), "mask_b": str(tmp_path / "m1.npy")}],
        "morph": {"iters_coarse": 8}, "video": {"warm_iters_fine": 4, "flow_iters": 10},
        "output": str(tmp_path / "out.vmc"),
    }
    with open(tmp_path / "job.json", "w") as f:
        json.dump(proj, f)
    assert cli.main(["project", str(tmp_path / "job.json"), "--device", "cpu"]) == 0
    got = load_clip(proj["output"])
    ref = api.morph_clips_layered(ca, cb, [dict(mask0=m0, mask1=m1)], pts, mp=FAST_MP, vp=FAST_VP, device="cpu")
    assert got.shape == (T_LEN, H, W, 3)
    np.testing.assert_array_equal(got, to_uint8(ref.frames.numpy()) / np.float32(255.0))


def test_layered_image_project_and_import(tmp_path):
    clip_a, clip_b = bench._make_clips(1, H, W, seed=3)
    for name, img in (("a.png", clip_a[0]), ("b.png", clip_b[0])):
        save_image(str(tmp_path / name), img)
    mask = np.zeros((H, W, 3), np.float32)
    mask[6:18, 8:24] = 1.0
    save_image(str(tmp_path / "m.png"), mask)
    xml = """<project>
      <image0>a.png</image0><image1>b.png</image1>
      <settings frames="3" output="out.vmc"/>
      <layer0 mask_a="m.png" mask_b="m.png"><pair x0="12" y0="12" x1="14" y1="12"/></layer0>
    </project>"""
    (tmp_path / "job.xml").write_text(xml)
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}
    run = subprocess.run(
        [sys.executable, "-m", "videomorphing_tpu_torch.cli", "import", str(tmp_path / "job.xml"),
         "--out", str(tmp_path / "job.json")],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert run.returncode == 0, run.stderr
    assert "1 pairs, 2 masks" in run.stdout
    proj = load_project(str(tmp_path / "job.json"))
    assert proj.n_frames == 3 and proj.layers[0]["points"] == [[[12.0, 12.0], [12.0, 14.0]]]
    proj_d = json.loads((tmp_path / "job.json").read_text())
    proj_d["morph"] = {"iters_coarse": 8}
    (tmp_path / "job.json").write_text(json.dumps(proj_d))
    assert cli.main(["project", str(tmp_path / "job.json"), "--device", "cpu"]) == 0
    got = load_clip(str(tmp_path / "out.vmc"))
    q = lambda x: to_uint8(x) / np.float32(255.0)
    layer = dict(mask0=q(mask).mean(-1), mask1=q(mask).mean(-1), points=np.asarray(proj.layers[0]["points"], np.float32))
    ref = api.morph_pair_layered(q(clip_a[0]), q(clip_b[0]), [layer], n_frames=3, mp=FAST_MP, device="cpu")
    np.testing.assert_array_equal(got, q(ref.numpy()))


BATCH_FAST = ["--levels", "2", "--iters", "8", "--device", "cpu"]
BATCH_MP = MorphParams(n_levels=2, iters_coarse=8)


def test_batch_manifest_writes_run_manifest(tmp_path, capsys):
    from videomorphing_tpu_torch.parallel.batch import run_manifest
    from videomorphing_tpu_torch.parallel.mesh import make_mesh

    (a0, b0), (a1, b1) = (bench._make_clips(1, H, W, seed=s) for s in (4, 5))
    save_image(str(tmp_path / "a0.png"), a0[0])
    save_image(str(tmp_path / "b0.png"), b0[0])
    np.save(tmp_path / "a1.npy", a1[0])
    np.save(tmp_path / "b1.npy", to_uint8(b1[0]))
    pts = [[[H * 0.5, W * 0.45], [H * 0.5, W * 0.55]]]
    spec = {"jobs": [
        {"a": str(tmp_path / "a0.png"), "b": str(tmp_path / "b0.png"), "points": pts, "out": str(tmp_path / "o0.vmc")},
        {"a": str(tmp_path / "a1.npy"), "b": str(tmp_path / "b1.npy"), "n_frames": 2, "out": str(tmp_path / "o1.vmc")},
    ]}
    (tmp_path / "jobs.json").write_text(json.dumps(spec))
    argv = ["batch", "--manifest", str(tmp_path / "jobs.json"), "--frames", "3", "--multihost", "-v"] + BATCH_FAST
    assert cli.main(argv) == 0
    events = _events(capsys.readouterr().err)
    mh = [e for e in events if e["event"] == "multihost"][0]
    assert (mh["process"], mh["n_processes"], mh["jobs"]) == (0, 1, 2)
    metrics = [e for e in events if e["event"] == "metrics"][-1]
    assert metrics["jobs"] == 2 and metrics["frames_per_sec"] > 0
    q = lambda x: to_uint8(x) / np.float32(255.0)
    jobs = [dict(i0=q(a0[0]), i1=q(b0[0]), points=np.asarray(pts, np.float32), n_frames=3),
            dict(i0=a1[0], i1=q(b1[0]), points=None, n_frames=2)]
    ref = run_manifest(jobs, make_mesh(devices=["cpu"]), BATCH_MP)
    for k, frames in enumerate(ref):
        np.testing.assert_array_equal(load_clip(str(tmp_path / f"o{k}.vmc")), q(frames))


def test_batch_clips_write_run_clip_pair(clip_files, tmp_path, capsys):
    from videomorphing_tpu_torch.io.clips import open_clip_reader, save_clip
    from videomorphing_tpu_torch.parallel.batch import StreamingBatchRunner
    from videomorphing_tpu_torch.parallel.mesh import make_mesh

    d, ca, cb, pts = clip_files
    save_clip(str(tmp_path / "a.vmc"), ca)
    save_clip(str(tmp_path / "b.vmc"), cb)
    out = str(tmp_path / "out.vmc")
    assert cli.main(["batch", "--clip-a", str(tmp_path / "a.vmc"), "--clip-b", str(tmp_path / "b.vmc"),
                     "--points", str(d / "p.json"), "--out", out, "-v"] + BATCH_FAST) == 0
    metrics = [e for e in _events(capsys.readouterr().err) if e["event"] == "metrics"][-1]
    assert metrics["resolution"] == f"{H}x{W}" and metrics["frames_per_sec"] > 0
    runner = StreamingBatchRunner(make_mesh(devices=["cpu"]), BATCH_MP)
    ref = np.concatenate([f for _, f in runner.run_clip_pair(
        open_clip_reader(str(tmp_path / "a.vmc")), open_clip_reader(str(tmp_path / "b.vmc")),
        T_LEN, (H, W), points=pts)])
    np.testing.assert_array_equal(load_clip(out), to_uint8(ref) / np.float32(255.0))
    assert cli.main(["batch", "--device", "cpu"]) == 2


@pytest.mark.parametrize("sub", ["pair", "video", "project", "batch"])
def test_default_device_raises_without_a_card(monkeypatch, tmp_path, sub):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "job.json").write_text(json.dumps({"source_a": "a.vmc", "source_b": "b.vmc"}))
    argv = {"pair": ["pair", "a.png", "b.png"], "video": ["video", "a.vmc", "b.vmc"],
            "project": ["project", str(tmp_path / "job.json")],
            "batch": ["batch", "--manifest", str(tmp_path / "job.json")]}[sub]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)


@pytest.mark.parametrize("sub", ["edit", "bench"])
def test_unported_subcommands_are_not_registered(sub, capsys):
    """The two subcommands once unported, ``edit`` and ``bench``, are
    registered now, each on the card by default."""
    if sub == "edit":
        args = cli.build_parser().parse_args(["edit", "a.png", "b.png"])
        assert args.fn is cli.cmd_edit and args.device == "cuda" and args.out == "points.json"
        return
    args = cli.build_parser().parse_args([sub])
    assert args.fn is cli.cmd_bench and args.device == "cuda"
