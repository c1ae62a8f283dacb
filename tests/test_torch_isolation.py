"""The port's boundaries: no jax, device dispatch, no silent fallback.

- importing the port's modules (the API, the layered morphs, the command
  line, io, metrics, the field store, the batch tier, the native reader,
  the golden cases and the stressor, and every subpackage among them)
  loads neither ``jax`` nor the JAX package (checked in a fresh
  interpreter), and ``chip_smoke.py`` imports neither, nor ``bench``;
- the configuration mirrors the reference's dataclasses field for field;
- on CPU tensors the kernel wrappers (the sampler's batched form too) run
  their plain versions and leave their launch counters at 0;
- the seven mesh entry points (the multi-device video paths) run with a
  CPU mesh;
- ``pack_dtype="bfloat16"`` raises, and ``build.py`` raises without nvcc.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import videomorphing_tpu.config as jax_config
from videomorphing_tpu_torch import config as port_config
from videomorphing_tpu_torch.interop import level_data_from_numpy
from videomorphing_tpu_torch.kernels import build
from videomorphing_tpu_torch.kernels import sweep as ks
from videomorphing_tpu_torch.kernels import warp as kw
from videomorphing_tpu_torch.solver.descent import make_level_solver

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "videomorphing_tpu_torch"


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import videomorphing_tpu_torch.api, videomorphing_tpu_torch.interop\n"
        "import videomorphing_tpu_torch.video.pipeline, videomorphing_tpu_torch.video.flow\n"
        "import videomorphing_tpu_torch.video.temporal, videomorphing_tpu_torch.video.occlusion\n"
        "import videomorphing_tpu_torch.models.video_morph, videomorphing_tpu_torch.utils.profiling\n"
        "import videomorphing_tpu_torch.models.layered, videomorphing_tpu_torch.video.layered\n"
        "import videomorphing_tpu_torch.cli, videomorphing_tpu_torch.io, videomorphing_tpu_torch.io.y4m\n"
        "import videomorphing_tpu_torch.io.project_xml, videomorphing_tpu_torch.utils.logging\n"
        "import videomorphing_tpu_torch.utils.checkpoint, videomorphing_tpu_torch.parallel.spatial\n"
        "import videomorphing_tpu_torch.parallel.frames, videomorphing_tpu_torch.parallel.video_blocks\n"
        "import videomorphing_tpu_torch.ops, videomorphing_tpu_torch.solver, videomorphing_tpu_torch.synth\n"
        "import videomorphing_tpu_torch.video, videomorphing_tpu_torch.models, videomorphing_tpu_torch.parallel\n"
        "import videomorphing_tpu_torch.utils, videomorphing_tpu_torch.utils.synthetic\n"
        "import videomorphing_tpu_torch.parallel.batch, videomorphing_tpu_torch.parallel.multihost\n"
        "import videomorphing_tpu_torch.utils.native, videomorphing_tpu_torch.utils.golden\n"
        "import videomorphing_tpu_torch.utils.stressor, videomorphing_tpu_torch.config\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'videomorphing_tpu' or m.startswith('videomorphing_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_sources_never_import_jax():
    for path in PKG.rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert mod.split(".")[0] not in ("jax", "videomorphing_tpu"), f"{path}: {s}"


def test_chip_smoke_imports_no_bench_and_no_jax():
    """``chip_smoke.py`` runs where there is no jax: it imports neither the
    JAX package, nor jax, nor the JAX benchmark harness ``bench``, at any
    level (its clips come from ``utils.synthetic``)."""
    import ast

    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0])
    assert "videomorphing_tpu_torch" in mods
    assert not mods & {"bench", "jax", "videomorphing_tpu"}, sorted(mods)


@pytest.mark.parametrize("cls", ["MorphParams", "SynthParams", "VideoParams"])
def test_config_mirrors_reference(cls):
    ref = getattr(jax_config, cls)
    port = getattr(port_config, cls)
    ref_f = [(f.name, f.default) for f in dataclasses.fields(ref)]
    port_f = [(f.name, f.default) for f in dataclasses.fields(port)]
    assert port_f == ref_f
    if cls == "MorphParams":
        for n_levels in (1, 4, 7):
            for level in range(n_levels):
                assert port().iters_for_level(level, n_levels) == ref().iters_for_level(level, n_levels)


def _small():
    rng = np.random.default_rng(0)
    h, w = 20, 24
    data = level_data_from_numpy(rng.random((h, w, 3), dtype=np.float32),
                                 rng.random((h, w, 3), dtype=np.float32))
    v = torch.from_numpy((0.5 * rng.standard_normal((h, w, 2))).astype(np.float32))
    return data, v


def test_cpu_tensors_take_the_plain_versions():
    data, v = _small()
    p = port_config.MorphParams()
    planes = kw.halfway_warp(data.i0, data.i1, v)
    torch.testing.assert_close(planes, kw.halfway_warp_plain(data.i0, data.i1, v), rtol=0, atol=0)
    e, g, pc = ks.sweep_grad(planes, v, v, data, p)
    e_p, g_p, pc_p = ks.sweep_grad_plain(planes, v, v, data, p)
    assert float(e) == float(e_p) and torch.equal(g, g_p) and torch.equal(pc, pc_p)
    assert float(ks.sweep_energy(planes, v, v, data, p)) == float(ks.sweep_energy_plain(planes, v, v, data, p))
    s = kw.bilinear_sample(data.i0, v + 3.0)
    assert torch.equal(s, kw.bilinear_sample_plain(data.i0, v + 3.0))
    for fn in (kw.halfway_warp, kw.bilinear_sample, ks.sweep_grad, ks.sweep_energy,
               kw.halfway_warp_rows, ks.sweep_grad_shard, ks.sweep_energy_shard):
        assert fn.launches == 0, fn.__name__


def test_batched_sampler_on_cpu_tensors_counts_nothing():
    data, v = _small()
    imgs = torch.stack([data.i0, data.i1])
    coords = torch.stack([v + 3.0, v - 2.0])
    out = kw.bilinear_sample_batched(imgs, coords)
    assert torch.equal(out, kw.bilinear_sample_batched_plain(imgs, coords))
    assert kw.bilinear_sample_batched.launches == 0


def test_mesh_raises():
    """The seven calls that raised on a mesh before the parallel port now
    run with a two-device CPU mesh (and still raise on a non-mesh)."""
    from videomorphing_tpu_torch import api
    from videomorphing_tpu_torch.models.video_morph import VideoMorpher
    from videomorphing_tpu_torch.parallel.mesh import make_mesh
    from videomorphing_tpu_torch.video import layered, pipeline

    mesh = make_mesh((2,), devices=["cpu", "cpu"])
    mp = port_config.MorphParams(n_levels=1, iters_coarse=2, iters_fine=2)
    vp = port_config.VideoParams(flow_iters=2, warm_iters_fine=2)
    clip = torch.rand((2, 16, 16, 3), generator=torch.Generator().manual_seed(0))
    layers = [dict(mask0=torch.ones(16, 16), mask1=torch.ones(16, 16))]
    calls = (
        lambda m: pipeline.solve_clip_fields(clip, clip, mp=mp, vp=vp, mesh=m)[0],
        lambda m: pipeline.render_video(clip, clip, torch.zeros((2, 16, 16, 2)), vp=vp, mesh=m).frames,
        lambda m: pipeline.morph_video(clip, clip, mp=mp, vp=vp, mesh=m).frames,
        lambda m: VideoMorpher(mp, vp=vp, device="cpu")(clip, clip, mesh=m).frames,
        lambda m: api.morph_clips(clip, clip, mp=mp, vp=vp, mesh=m, device="cpu").frames,
        lambda m: api.morph_clips_layered(clip, clip, layers, mp=mp, vp=vp, mesh=m, device="cpu").frames,
        lambda m: layered.solve_clip_fields_layered(clip, clip, [], mp=mp, vp=vp, mesh=m)[0],
    )
    for call in calls:
        out = call(mesh)
        assert out.shape[:3] == (2, 16, 16) and torch.isfinite(out).all()
        with pytest.raises(TypeError, match="Mesh"):
            call(object())


def test_mixed_devices_raise():
    data, v = _small()
    with pytest.raises(ValueError):
        kw.bilinear_sample(data.i0, v.to("meta"))


def test_bfloat16_pack_raises():
    with pytest.raises(ValueError, match="pack_dtype"):
        make_level_solver(port_config.MorphParams(pack_dtype="bfloat16"), 4)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load()
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").rglob("*.so"))


def test_build_compiles_only_the_package_sources():
    srcs = build.sources()
    assert {p.name for p in srcs} == {"warp.cu", "sweep.cu"}
    assert all(p.parent == PKG / "csrc" for p in srcs)
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
    for p in srcs:
        assert "torch/extension.h" not in p.read_text()
