"""The port's copies of the JAX package's numpy-only I/O: clips, projects
and the field store.

- each clip format round-trips through the port (uint8 quantization: a
  float frame comes back as ``to_float(to_uint8(x))`` exactly; a C444 .y4m
  within 0.02, the reference's bound for the limited-range BT.601 rounding);
- a clip written by either package reads bitwise equal in the other;
- a JSON project and an XML project load to equal field values in both;
- ``FieldStore`` resumes at the first pending frame, and a store written by
  either package reads in the other.
"""

import dataclasses
import json

import numpy as np
import pytest

from videomorphing_tpu.io import clips as jclips
from videomorphing_tpu.io import project as jproject
from videomorphing_tpu.io import project_xml as jxml
from videomorphing_tpu.utils.checkpoint import FieldStore as JaxFieldStore
from videomorphing_tpu_torch import io as tio
from videomorphing_tpu_torch.io import clips as tclips
from videomorphing_tpu_torch.io import project as tproject
from videomorphing_tpu_torch.io import project_xml as txml
from videomorphing_tpu_torch.io import y4m as ty4m
from videomorphing_tpu_torch.utils.checkpoint import FieldStore


def _clip(seed=0, t=3, h=10, w=12, c=3):
    return np.random.default_rng(seed).random((t, h, w, c), dtype=np.float32)


@pytest.mark.parametrize("name", ["c.npz", "c.vmc", "frames"])
def test_round_trip_exact(tmp_path, name):
    x = _clip()
    path = str(tmp_path / name)
    tio.save_clip(path, x)
    back = tio.load_clip(path)
    np.testing.assert_array_equal(back, tio.to_float(tio.to_uint8(x)))
    blocks = list(tclips.open_clip_reader(path, block=2))
    assert [s for s, _ in blocks] == [0, 2]
    np.testing.assert_array_equal(np.concatenate([b for _, b in blocks]), back)


def test_npy_and_uint8_input(tmp_path):
    x = (_clip() * 255).astype(np.uint8)
    np.save(tmp_path / "c.npy", x)
    np.testing.assert_array_equal(tio.load_clip(str(tmp_path / "c.npy")), x.astype(np.float32) / 255.0)
    tclips.write_vmc(str(tmp_path / "u.vmc"), x)
    assert tclips.read_vmc_header(str(tmp_path / "u.vmc")) == (3, 10, 12, 3)
    np.testing.assert_array_equal(tclips.read_vmc(str(tmp_path / "u.vmc"), 1, 5), x[1:].astype(np.float32) / 255.0)
    with pytest.raises(ValueError, match="unsupported clip source"):
        tio.load_clip(str(tmp_path / "c.bin"))


@pytest.mark.parametrize("chroma", ["444", "420jpeg"])
def test_y4m_round_trip(tmp_path, chroma):
    x = _clip(h=10, w=12)
    path = str(tmp_path / "c.y4m")
    ty4m.write_y4m(path, x, fps=(25, 1), chroma=chroma)
    t, h, w, c, fps = ty4m.read_y4m_header(path)
    assert (t, h, w, c, fps) == (3, 10, 12, chroma, (25, 1))
    back = tio.load_clip(path)
    assert back.shape == x.shape
    if chroma == "444":
        assert np.abs(back - x).max() < 0.02
    blocks = list(tclips.open_clip_reader(path, block=2))
    np.testing.assert_array_equal(np.concatenate([b for _, b in blocks]), back)


def test_vmc_writer_appends(tmp_path):
    x = _clip(t=5)
    path = str(tmp_path / "s.vmc")
    with tclips.VmcWriter(path) as wr:
        wr.append(x[:2])
        wr.append(x[2])
        wr.append(x[3:])
        with pytest.raises(ValueError, match="frame shape changed"):
            wr.append(x[:1, :5])
    assert tclips.read_vmc_header(path) == (5, 10, 12, 3)
    np.testing.assert_array_equal(tio.load_clip(path), tio.to_float(tio.to_uint8(x)))


@pytest.mark.parametrize("name", ["c.npz", "c.vmc", "c.y4m", "frames"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_clips_cross_packages_bitwise(tmp_path, name, writer):
    x = _clip(seed=4, h=8, w=10)
    path = str(tmp_path / name)
    (jclips if writer == "reference" else tclips).save_clip(path, x)
    np.testing.assert_array_equal(tclips.load_clip(path), jclips.load_clip(path))


@pytest.mark.parametrize("name", ["c.vmc", "c.y4m"])
def test_clip_writers_emit_the_same_bytes(tmp_path, name):
    x = _clip(seed=5, h=8, w=10)
    jclips.save_clip(str(tmp_path / ("r_" + name)), x)
    tclips.save_clip(str(tmp_path / ("p_" + name)), x)
    assert (tmp_path / ("r_" + name)).read_bytes() == (tmp_path / ("p_" + name)).read_bytes()


PROJECT = {
    "source_a": "a.vmc",
    "source_b": "b.vmc",
    "keyframes": {"0": [[[1.0, 2.0], [3.0, 4.0]]], "5": [[[5.0, 6.0], [7.0, 8.0]]]},
    "times": [0.0, 0.25, 1.0],
    "layers": [{"mask_a": "m0.npy", "mask_b": "m1.npy", "points": [[[1.0, 1.0], [2.0, 2.0]]]}],
    "morph": {"lambda_tps": 0.01, "iters_coarse": 40},
    "synth": {"blend_mode": "linear", "occlusion_weighting": False},
    "video": {"flow_iters": 12},
    "output": "out.vmc",
}


def _assert_projects_equal(ref, got):
    for name in ("source_a", "source_b", "n_frames", "output", "layers"):
        assert getattr(got, name) == getattr(ref, name), name
    for sec in ("morph", "synth", "video"):
        assert dataclasses.asdict(getattr(got, sec)) == dataclasses.asdict(getattr(ref, sec)), sec
    if isinstance(ref.points, dict):
        assert sorted(got.points) == sorted(ref.points)
        for k in ref.points:
            np.testing.assert_array_equal(got.points[k], ref.points[k])
    else:
        np.testing.assert_array_equal(got.points, ref.points)
    if ref.times is None:
        assert got.times is None
    else:
        np.testing.assert_array_equal(got.times, ref.times)


def test_json_project_loads_equal(tmp_path):
    path = str(tmp_path / "job.json")
    with open(path, "w") as f:
        json.dump(PROJECT, f)
    ref, got = jproject.load_project(path), tproject.load_project(path)
    _assert_projects_equal(ref, got)
    assert got.morph.lambda_tps == 0.01 and got.synth.blend_mode == "linear" and got.video.flow_iters == 12
    tproject.save_project(str(tmp_path / "again.json"), got)
    _assert_projects_equal(ref, tproject.load_project(str(tmp_path / "again.json")))


def test_xml_project_imports_equal(tmp_path):
    xml = """<?xml version="1.0"?>
    <project>
      <image0>a.png</image0>
      <image1>b.png</image1>
      <settings w_tps="0.02" weight_ui="80" frames="12" output="res.vmc"/>
      <points>
        <pair x0="10" y0="20" x1="14" y1="26"/>
        <pair x0="40" y0="50" x1="44" y1="56"/>
      </points>
      <layer0 mask_a="m0.png" mask_b="m1.png"><pair x0="1" y0="1" x1="2" y1="2"/></layer0>
      <mystery_knob>42</mystery_knob>
    </project>"""
    path = str(tmp_path / "job.xml")
    with open(path, "w") as f:
        f.write(xml)
    (ref, ref_report), (got, got_report) = jxml.import_xml_project(path), txml.import_xml_project(path)
    _assert_projects_equal(ref, got)
    assert got_report == ref_report
    assert got.morph.gamma_ui == 80.0 and got.n_frames == 12
    np.testing.assert_array_equal(got.points, [[[20, 10], [26, 14]], [[50, 40], [56, 44]]])


def test_field_store_resumes(tmp_path):
    path = str(tmp_path / "f.npz")
    rng = np.random.default_rng(2)
    v = rng.standard_normal((4, 6, 8, 2)).astype(np.float32)
    store = FieldStore(path)
    assert store.first_pending() == 0 and store.done.shape == (0,)
    store.init(4, 6, 8)
    store.put([0, 1], v[:2], v[:2] * 0.5)
    store.save()
    again = FieldStore(path)
    assert again.first_pending() == 2 and again.done.tolist() == [True, True, False, False]
    np.testing.assert_array_equal(again.fields()[0][:2], v[:2])
    np.testing.assert_array_equal(again.fields()[1][:2], v[:2] * 0.5)
    again.init(4, 6, 8)  # same shape: keeps what is stored
    again.put(np.arange(2, 4), v[2:])
    again.save()
    done = FieldStore(path)
    assert done.first_pending() == 4
    np.testing.assert_array_equal(done.fields()[0], v)
    done.init(4, 3, 8)  # another resolution starts over
    assert done.first_pending() == 0


@pytest.mark.parametrize("writer", [JaxFieldStore, FieldStore])
def test_field_store_cross_packages(tmp_path, writer):
    path = str(tmp_path / "f.npz")
    v = np.random.default_rng(3).standard_normal((3, 4, 5, 2)).astype(np.float32)
    store = writer(path)
    store.init(3, 4, 5)
    store.put([0], v[:1], v[:1])
    store.save()
    for reader in (JaxFieldStore, FieldStore):
        s = reader(path)
        assert s.first_pending() == 1
        np.testing.assert_array_equal(s.fields()[0][0], v[0])
