"""The port's demos (``examples/demo_pair_torch.py``,
``examples/demo_video_torch.py``) run end to end on the CPU, as
``tests/test_examples.py`` runs the reference's: each in a child process
with ``--device cpu`` and ``VMORPH_DEMO_SHAPE=4x72x104``. Each must exit 0
(its own check passes: the disk's centroid sweeps from A towards B, or the
mid frame's lands between the takes), write its artifacts (a ``.y4m`` that
starts with the YUV4MPEG2 magic), and load neither ``jax`` nor the JAX
package.

Then each demo's ``compute`` on the CPU beside the reference demo's own
calls on the same inputs. Both morphs are as sensitive to float32
rounding as the reference is to itself, so each tolerance is about twice
the reference's own distance under 1-ulp input noise (three draws each):

- the pair (``make_scene``, 128 x 160, the default ``MorphParams``): the
  disk on a static background leaves the field a foldover-free compromise,
  and 1-ulp noise moves the reference's field by 0.29-0.50 px mean abs
  (5.5-7.9 px max), its frames by 0.0060-0.0089 mean abs, its halfway view
  by 0.0072-0.0111 mean abs, its per-frame disk centroids by 0.17-0.67 px
  and its largest displacement by 0.004-0.81 px. The port must be within
  1.0 px, 0.02, 0.025, 1.5 px and 1.6 px of the reference (measured: 0.505
  px, 0.0094, 0.0114, 0.64 px, 0.74 px);
- the video (4 x 72 x 104, ``params=`` the reference's texture draws of
  seed 5, so the takes are the reference demo's within 1e-6): 1-ulp noise
  moves the reference's frames and layered frames by 0.029-0.040 max abs
  and 1.10e-4 to 1.15e-4 mean abs. The port must be within 0.08 max abs
  and 2.5e-4 mean abs (measured: 0.027 and 1.12e-4)."""

import importlib.util
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
torch.set_num_threads(2)

ARTIFACTS = {
    "demo_pair_torch.py": ("morph.y4m", "a.png", "b.png", "halfway.png", "field.png", "frames/frame_00000.png"),
    "demo_video_torch.py": ("morph.y4m", "layered.y4m", "take_a.y4m", "take_b.y4m", "strip.png", "fields.png",
                            "frames/frame_0000.png"),
}


def _run_demo(script: str, outdir: str) -> str:
    """The demo's ``__main__`` in a child process; prints the names of the
    JAX modules it loaded on its last line."""
    path = str(REPO / "examples" / script)
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{path!r}, {outdir!r}, '--device', 'cpu']\n"
        "rc = 0\n"
        "try:\n"
        f"    runpy.run_path({path!r}, run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "print('loaded:', sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'videomorphing_tpu')))\n"
        "sys.exit(rc)\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}
    env.update(VMORPH_DEMO_SHAPE="4x72x104", OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, env=env,
                       cwd=str(REPO))
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


@pytest.mark.parametrize("script", sorted(ARTIFACTS))
def test_port_demo_smoke(tmp_path, script):
    out = _run_demo(script, str(tmp_path))
    assert "morph.y4m" in out
    assert out.strip().splitlines()[-1] == "loaded: []", out
    for f in ARTIFACTS[script]:
        assert (tmp_path / f).exists(), f
    with open(tmp_path / "morph.y4m", "rb") as fh:
        assert fh.read(9) == b"YUV4MPEG2"


def _load(name: str):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_demo_pair_matches_reference():
    """``demo_pair_torch.compute`` against ``examples/demo_pair.py``'s
    ``api.solve_pair`` and ``api.morph_pair`` on the same scene."""
    from videomorphing_tpu import api as jax_api
    from videomorphing_tpu.viewer import halfway_image as jax_halfway_image

    demo = _load("demo_pair_torch")
    i0, i1, points = demo.make_scene()
    art = jax_api.solve_pair(i0, i1, points)
    v = np.asarray(art.v)
    frames = np.asarray(jax_api.morph_pair(i0, i1, points, n_frames=demo.N_FRAMES))
    halfway = np.clip(jax_halfway_image(i0, i1, art.v), 0, 1)
    got = demo.compute("cpu")
    assert got["ok"]
    assert got["v"].shape == v.shape and got["frames"].shape == frames.shape
    assert np.abs(got["v"] - v).mean() <= 1.0
    assert np.abs(got["frames"] - frames).mean() <= 0.02
    assert np.abs(got["halfway"] - halfway).mean() <= 0.025
    assert np.abs(np.array(got["centroids"]) - np.array(demo.centroids_x(frames))).max() <= 1.5
    assert abs(got["disp"] - float(np.linalg.norm(v, axis=-1).max())) <= 1.6


def test_demo_video_matches_reference():
    """``demo_video_torch.compute`` given the reference's texture draws
    against ``examples/demo_video.py``'s ``morph_video`` and
    ``morph_clips_layered`` on the same takes."""
    import jax.numpy as jnp

    from test_torch_stressor import jax_draws
    from videomorphing_tpu.utils.stressor import make_stressor
    from videomorphing_tpu.video.layered import VideoLayer, morph_clips_layered
    from videomorphing_tpu.video.pipeline import morph_video

    t_len, h, w = 4, 72, 104
    demo = _load("demo_video_torch")
    case = make_stressor(t_len, h, w, seed=5, drift=0.08)
    keyframe_points = {0: case.points}
    res = morph_video(case.clip_a, case.clip_b, points=keyframe_points, render=True)
    tracked = np.asarray(res.tracked_points)
    r = 0.16 * min(h, w) + 4.0
    m0, m1 = (demo._disk_masks(tracked, side, h, w, r) for side in (0, 1))
    layer = VideoLayer(mask0=jnp.asarray(m0), mask1=jnp.asarray(m1), points=keyframe_points)
    layered = morph_clips_layered(case.clip_a, case.clip_b, [layer], points=keyframe_points).frames
    got = demo.compute((t_len, h, w), "cpu", params=jax_draws(5))
    assert got["ok"]
    np.testing.assert_array_equal(got["points"], case.points)
    for name, ref in (("clip_a", case.clip_a), ("clip_b", case.clip_b)):
        assert np.abs(got[name] - np.asarray(ref)).max() <= 1e-6, name
    for name, ref in (("frames", res.frames), ("layered", layered)):
        d = np.abs(got[name] - np.asarray(ref))
        assert d.max() <= 0.08 and d.mean() <= 2.5e-4, (name, d.max(), d.mean())
