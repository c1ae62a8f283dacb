"""The port's native reader (``utils.native``) and ``io.clips.open_clip_reader``.

- ``native/vmio.cpp`` builds into a fresh build directory (never into
  ``native/``), and the build is reused;
- ``VmcStream`` and the numpy reader give bitwise-equal blocks, in the
  reference's reader's values (its ``VmcStream``, the same library), and
  within one float32 ulp (6e-8) of ``read_vmc``'s division;
- ``u8_to_f32`` equals ``u8_to_f32_plain`` bitwise, above and below the
  library's threading threshold;
- ``open_clip_reader`` says which reader it chose, and takes the numpy one
  when there is no C++ compiler.

The tests that build skip only where no C++ compiler is found.
"""

import numpy as np
import pytest

from videomorphing_tpu.io.clips import open_clip_reader as jax_open_clip_reader
from videomorphing_tpu_torch.io import clips as tclips
from videomorphing_tpu_torch.io.images import to_float
from videomorphing_tpu_torch.utils import native


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """The library built into ``tmp_path``, with its bound handle reset."""
    if native.find_cxx() is None:
        pytest.skip("no C++ compiler (g++, c++ or $CXX) found: native/vmio.cpp cannot be built")
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "vmio")
    monkeypatch.setattr(native, "_lib", None)
    return tmp_path / "vmio"


def _frames(seed=0, t=7, h=12, w=20):
    return np.random.default_rng(seed).integers(0, 256, (t, h, w, 3), dtype=np.uint8)


def test_builds_into_the_build_directory(fresh_build):
    src = native.SOURCE
    before = src.parent.stat().st_mtime_ns, sorted(p.name for p in src.parent.iterdir())
    assert native.ensure_built()
    lib = native.library_path()
    assert lib.is_file() and fresh_build in lib.parents
    stamp = lib.stat().st_mtime_ns
    assert native.ensure_built() and lib.stat().st_mtime_ns == stamp
    native.load_lib()
    assert (src.parent.stat().st_mtime_ns, sorted(p.name for p in src.parent.iterdir())) == before


@pytest.mark.parametrize("block", [1, 3, 8])
def test_stream_equals_numpy_blocks(fresh_build, tmp_path, block):
    frames = _frames()
    path = str(tmp_path / "c.vmc")
    tclips.write_vmc(path, frames)
    reader = tclips.open_clip_reader(path, block=block)
    assert reader.kind == "native"
    got = list(reader)
    plain = list(tclips.ClipBlocks(tclips._vmc_blocks(path, block), "numpy"))
    assert [s for s, _ in got] == [s for s, _ in plain] == list(range(0, 7, block))
    for (_, a), (_, b) in zip(got, plain):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    ref = np.concatenate([b for _, b in jax_open_clip_reader(path, block=block)])
    np.testing.assert_array_equal(np.concatenate([b for _, b in got]), ref)
    np.testing.assert_allclose(np.concatenate([b for _, b in got]), to_float(frames), rtol=0, atol=6e-8)


@pytest.mark.parametrize("shape", [(5, 7, 3), (3, 1000, 1000)])
def test_u8_to_f32(fresh_build, shape):
    x = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(native.u8_to_f32(x), native.u8_to_f32_plain(x))
    every = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(native.u8_to_f32(every), native.u8_to_f32_plain(every))
    assert native.u8_to_f32_plain(every)[[0, 255]].tolist() == [0.0, 1.0]


def test_numpy_reader_without_a_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "vmio")
    monkeypatch.setattr(native, "find_cxx", lambda: None)
    frames = _frames(2, t=4)
    path = str(tmp_path / "c.vmc")
    tclips.write_vmc(path, frames)
    assert not native.ensure_built()
    reader = tclips.open_clip_reader(path, block=3)
    assert reader.kind == "numpy"
    blocks = list(reader)
    assert [s for s, _ in blocks] == [0, 3]
    np.testing.assert_array_equal(np.concatenate([b for _, b in blocks]), native.u8_to_f32_plain(frames))
    with pytest.raises(ImportError, match="no C\\+\\+ compiler"):
        monkeypatch.setattr(native, "_lib", None)
        native.load_lib()


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "vmio")
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    if native.find_cxx() is None:
        pytest.skip("no C++ compiler (g++, c++ or $CXX) found: native/vmio.cpp cannot be built")
    with pytest.raises(RuntimeError, match="bad.cpp"):
        native.ensure_built()
    assert not any((tmp_path / "vmio").rglob("*.so"))
