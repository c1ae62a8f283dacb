"""The port's benchmark (``videomorphing_tpu_torch.bench``) against the reference's ``bench.py``.

- ``LINE_KEYS`` holds the key sets of the reference's lines, read from
  ``bench.py``'s source (its dict literals and the keys it
  stores into ``out``/``extra``), and each port function accepts the
  parameter names of its reference function;
- ``bench_pair`` gives the key set of the reference's ``_bench_pair`` on
  the same shape, both run here; ``run_bench``, ``bench_kernels``,
  ``bench_golden``, ``bench_batch_4k``, ``bench_batch_stream`` and
  ``main``'s configs give their keys with positive values at small shapes
  on the CPU (``compiled`` false, no launch counted); the stream's
  temporary directory is gone afterwards;
- ``make_clips_device`` follows the formula of the reference's clips: its
  frames differ from frame 0 as ``bench._make_clips``'s do (the textures
  differ: a ``torch.Generator`` draw);
- without a card ``main`` and ``cli bench`` print the error line, return 1
  and run nothing; a failed kernel or golden check still prints the line
  and returns 1; ``cli bench --device cpu`` prints the headline keys.

The solves run with fewer iterations (``BENCH_SET``, as the reference's
A/B runs set it) or, for the golden cases, a ``MorphParams`` of 3 levels
and 8 coarse iterations: these tests check the keys and the flow, not the
fields.
"""

import ast
import inspect
import json
import os
import pathlib
import tempfile

import numpy as np
import pytest
import torch

import bench as ref_bench
from videomorphing_tpu_torch import bench, cli
from videomorphing_tpu_torch.config import MorphParams
from videomorphing_tpu_torch.kernels import sweep as ks
from videomorphing_tpu_torch.kernels import warp as kw

torch.set_num_threads(2)
FAST_SET = "morph.n_levels=2,morph.iters_coarse=8,video.warm_iters_fine=4,video.flow_iters=10"
SMALL = {"BENCH_H": "32", "BENCH_W": "48", "BENCH_FRAMES": "2"}
CPU = torch.device("cpu")
REF_TREE = ast.parse(pathlib.Path(ref_bench.__file__).read_text())
# the reference function that prints each config's line
REF_FUNCTION = {
    "video_1080p": "main", "video_480p": "main", "error": "main",
    "pair_256": "_bench_pair", "pair_1k": "_bench_pair",
    "kernels": "_bench_kernels", "golden": "_bench_golden",
    "batch_4k": "_bench_batch_4k", "batch_4k_stream": "_bench_batch_stream",
}
PORT_OF = {
    "_make_clips_device": bench.make_clips_device, "_bench_params": bench.bench_params,
    "run_bench": bench.run_bench, "_bench_pair": bench.bench_pair, "_bench_batch_4k": bench.bench_batch_4k,
    "_bench_batch_stream": bench.bench_batch_stream, "_bench_kernels": bench.bench_kernels,
    "_bench_golden": bench.bench_golden, "main": bench.main,
}
COUNTED = (ks.sweep_energy, ks.sweep_grad, kw.halfway_warp, kw.bilinear_sample_batched)


def _reference_dicts(func: str):
    """The string keys of each non-empty dict literal in ``bench.<func>``
    (nested functions included), and the keys it stores by subscript
    (``out["sweep_grad"] = ...``, ``extra["kernel_compiled"] = ...``)."""
    fn = next(n for n in REF_TREE.body if isinstance(n, ast.FunctionDef) and n.name == func)
    dicts, stored = [], set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            keys = {k.value for k in node.keys if isinstance(k, ast.Constant)}
            if keys:
                dicts.append(keys)
        elif isinstance(node, ast.Assign):
            stored |= {t.slice.value for t in node.targets
                       if isinstance(t, ast.Subscript) and isinstance(t.slice, ast.Constant)}
    return dicts, stored


def _reference_keys(config: str) -> set:
    dicts, stored = _reference_dicts(REF_FUNCTION[config])
    if config == "error":
        (keys,) = [d for d in dicts if "error" in d]
        return {k for k in keys if not k.startswith("last_measured_")}
    if REF_FUNCTION[config] == "main":
        (keys,) = [d for d in dicts if "frames" in d]
    else:
        (keys,) = dicts
    return keys | stored


def _lines(text: str):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


@pytest.fixture
def no_launches():
    before = [fn.launches for fn in COUNTED]
    yield
    assert [fn.launches for fn in COUNTED] == before == [0] * len(COUNTED)


@pytest.mark.parametrize("config", list(bench.LINE_KEYS))
def test_line_keys_are_the_reference_s(config):
    keys = bench.LINE_KEYS[config]
    assert len(set(keys)) == len(keys)
    assert set(keys) == _reference_keys(config)


@pytest.mark.parametrize("ref_name", sorted(PORT_OF))
def test_functions_accept_the_reference_parameters(ref_name):
    ref = set(inspect.signature(getattr(ref_bench, ref_name)).parameters)
    port = set(inspect.signature(PORT_OF[ref_name]).parameters)
    assert ref <= port and port - ref <= {"device", "hw"}, (ref, port)


def test_bench_pair_has_the_reference_keys(monkeypatch, no_launches):
    monkeypatch.setenv("BENCH_SET", FAST_SET)
    ref = ref_bench._bench_pair(48, 64, n_frames=2)
    got = bench.bench_pair(48, 64, 2, device="cpu")
    assert set(got) == set(ref) == set(bench.PAIR_KEYS)
    assert got["metric"] == ref["metric"] == "pair_morph_48x64" and got["unit"] == "frames/s"
    assert all(got[k] > 0 for k in ("value", "iters_per_sec_per_mpix", "wall_seconds"))


def test_run_bench_times_distinct_runs(monkeypatch, no_launches):
    monkeypatch.setenv("BENCH_SET", FAST_SET)
    fps, walls, iters = bench.run_bench(3, 32, 48, repeats=2, device="cpu")
    assert fps > 0 and len(walls) == 2 and all(w > 0 for w in walls)
    assert fps == pytest.approx(3 / min(walls))
    assert isinstance(iters, int) and iters > 0


def test_bench_kernels_on_the_cpu(no_launches):
    line = bench.bench_kernels(device="cpu")
    assert set(line) == set(bench.LINE_KEYS["kernels"]) and line["compiled"] is False
    assert line["metric"] == "kernel_equivalence" and line["unit"] == "max_rel_err"
    # on CPU tensors each wrapper runs its plain version: no difference at all
    assert all(line[k] == 0.0 for k in bench.KERNEL_TOLERANCE) and line["value"] == 0.0
    assert bench.kernels_ok(line)
    assert not bench.kernels_ok({**line, "fused_sample": 1e-7})


def test_bench_golden_on_the_cpu(no_launches):
    line = bench.bench_golden(MorphParams(n_levels=3, iters_coarse=8), device="cpu", hw=(64, 64))
    assert set(line) == set(bench.LINE_KEYS["golden"]) and line["unit"] == "ssim"
    cases = [line[c] for c in ("translation", "rotation", "scale")]
    assert [c["case"] for c in cases] == ["translation", "rotation", "scale"]
    assert 0 < line["value"] == min(c["ssim_mid"] for c in cases) <= 1


def test_bench_batch_4k_keys(no_launches):
    line = bench.bench_batch_4k(device="cpu", hw=(32, 48))
    assert set(line) == set(bench.LINE_KEYS["batch_4k"])
    assert line["unit"] == "pairs/s" and line["value"] > 0 and line["wall_seconds"] > 0


def test_bench_batch_stream_keys(monkeypatch, tmp_path, no_launches):
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    line = bench.bench_batch_stream(device="cpu")
    assert set(line) == set(bench.LINE_KEYS["batch_4k_stream"])
    assert line["metric"] == "stream_pairs" and (line["h"], line["w"], line["frames"]) == (32, 48, 2)
    assert line["blocks"] == 2 and line["value"] > 0 and line["compute_block_s"] > 0
    assert 0 <= line["device_busy_frac"] <= 1 and isinstance(line["decode_keeps_ahead"], bool)
    assert list(tmp_path.iterdir()) == []  # the .vmc directory is removed


def test_make_clips_device_follows_the_reference_formula():
    t_len, h, w = 4, 40, 56
    a, b = (x.numpy() for x in bench.make_clips_device(t_len, h, w, 5, "cpu"))
    ra, rb = ref_bench._make_clips(t_len, h, w, seed=5)
    assert a.shape == ra.shape == (t_len, h, w, 3) and a.dtype == np.float32
    assert 0 <= a.min() and a.max() <= 1 and not np.array_equal(a, ra)
    for got, ref in ((a, ra), (b, rb)):
        # the texture cancels between frames wherever neither package clipped
        free = ((got > 0) & (got < 1) & (ref > 0) & (ref < 1)).all(0)
        np.testing.assert_allclose((got - got[:1])[:, free], (ref - ref[:1])[:, free], atol=2e-6)
    again = bench.make_clips_device(t_len, h, w, 5, "cpu")[0]
    assert torch.equal(again, torch.from_numpy(a))
    assert not torch.equal(bench.make_clips_device(t_len, h, w, 6, "cpu")[0], again)


@pytest.mark.parametrize("how", ["main_default", "main_kernels", "cli"])
def test_no_card_prints_the_error_line_and_runs_nothing(how, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def ran(*args, **kwargs):
        raise AssertionError("the bench ran without a card")

    for name in ("run_bench", "bench_pair", "bench_kernels", "bench_golden", "bench_batch_4k",
                 "bench_batch_stream", "make_clips_device"):
        monkeypatch.setattr(bench, name, ran)
    rc = {"main_default": lambda: bench.main([]), "main_kernels": lambda: bench.main(["kernels"]),
          "cli": lambda: cli.main(["bench"])}[how]()
    (line,) = _lines(capsys.readouterr().out)
    # the reference's error line without its TPU numbers (last_measured_*)
    assert rc == 1 and set(line) == _reference_keys("error") == {"metric", "value", "unit", "vs_baseline", "error"}
    assert line["value"] is None and line["vs_baseline"] is None and "no CUDA device" in line["error"]


def test_unknown_config_is_refused(capsys):
    assert bench.main(["video_4k"], device="cpu") == 2
    assert _lines(capsys.readouterr().out) == []


def _stub_video(monkeypatch):
    monkeypatch.setattr(bench, "run_bench", lambda t, h, w, repeats=3, device=None: (t / 1.0, [1.0, 1.25], 100))


@pytest.mark.parametrize("fault", ["kernels_raise", "kernel_off", "golden_raise", "golden_low"])
def test_a_failed_check_prints_the_line_and_fails(fault, monkeypatch, capsys):
    _stub_video(monkeypatch)
    good_k = {"value": 0.0, "compiled": True, **{k: 0.0 for k in bench.KERNEL_TOLERANCE}}

    def kernels(mp=None, device=None):
        if fault == "kernels_raise":
            raise RuntimeError("kernels not launched on the card")
        return {**good_k, "sweep_grad": 1e-3, "value": 1e-3} if fault == "kernel_off" else good_k

    def golden(mp=None, device=None, hw=(256, 256)):
        if fault == "golden_raise":
            raise RuntimeError("no golden")
        return {"value": 0.5 if fault == "golden_low" else 0.999}

    monkeypatch.setattr(bench, "bench_kernels", kernels)
    monkeypatch.setattr(bench, "bench_golden", golden)
    assert bench.main(["video_480p"], device="cpu") == 1
    (line,) = _lines(capsys.readouterr().out)
    assert set(line) == set(bench.HEADLINE_KEYS) and line["value"] == 30.0
    assert line["wall_seconds"] == [1.0, 1.25] and line["wall_spread_pct"] == 25.0
    if fault == "kernels_raise":
        assert line["kernel_max_rel_err"].startswith("error: ") and line["kernel_compiled"] is None
    if fault == "golden_raise":
        assert line["golden_midpoint_ssim"] == "error: no golden"


def test_main_kernels_config(capsys, no_launches):
    assert bench.main(["kernels"], device="cpu") == 0
    (line,) = _lines(capsys.readouterr().out)
    assert set(line) == set(bench.LINE_KEYS["kernels"]) and line["compiled"] is False


def test_cli_bench_on_the_cpu(monkeypatch, capsys, no_launches):
    env = dict(SMALL, BENCH_CONFIG="video_480p", BENCH_REPEATS="1", BENCH_SET=FAST_SET)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []

    def kernels(mp=None, device=None):
        calls.append(("kernels", mp, device))
        return {"value": 0.0, "compiled": False, **{k: 0.0 for k in bench.KERNEL_TOLERANCE}}

    def golden(mp=None, device=None, hw=(256, 256)):
        calls.append(("golden", mp, device))
        return {"value": 0.995}

    monkeypatch.setattr(bench, "bench_kernels", kernels)
    monkeypatch.setattr(bench, "bench_golden", golden)
    assert cli.main(["bench", "--device", "cpu"]) == 0
    out = capsys.readouterr()
    (line,) = _lines(out.out)
    assert set(line) == set(bench.HEADLINE_KEYS)
    assert line["metric"] == "morph_frames_per_sec_32p" and line["frames"] == 2 and line["value"] > 0
    assert line["vs_baseline"] is None and len(line["wall_seconds"]) == 1
    assert line["iters_per_sec_per_mpix"] > 0 and line["kernel_max_rel_err"] == 0.0
    assert line["kernel_compiled"] is False and line["golden_midpoint_ssim"] == 0.995
    mp = bench.bench_params()[0]
    assert mp.n_levels == 2 and calls == [("kernels", mp, CPU), ("golden", mp, CPU)]
    assert "# 2 frames 48x32" in out.err and out.err.rstrip().endswith("cpu")
