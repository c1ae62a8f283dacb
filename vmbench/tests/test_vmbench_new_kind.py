"""A cell of a new kind arrives as new files and new entries in
``BENCHMARK.json``, and the harness and its tests take it as they are.

(a) Each fault of ``faults`` changes what each entry of the program that a
kind drives, or that the cells to come name, gives: ``ImageMorpher.solve``
then ``.render`` (the pair), ``api.morph_clips`` (the video) and
``parallel.batch.make_batch_step`` (the batch tier), at 36 x 44 on the CPU
from the benchmark's own seeded inputs.

(b) A checkout whose ``BENCHMARK.json`` has one more cell, of a kind
``stub`` that the harness has never seen, with its configuration (cut, so
``reduced`` lists the cut keys) and its mix as new files: the contract's
checks pass, and ``run.run_cell`` comes out correct, and not correct under
a fault."""

import json
import shutil
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import contract
from faults import FAULTS

from vmbench import inputs, run
from vmbench.kinds import pair

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 12345
H, W = 36, 44
TIMES = np.array([0.0, 0.5, 1.0], np.float32)


def config(name: str) -> dict:
    return json.loads((ROOT / "vmbench" / "configs" / f"{name}.json").read_text())


def user_points() -> torch.Tensor:
    return torch.from_numpy(inputs.user_points(H, W, 4))


def image_morpher():
    from videomorphing_tpu_torch.config import MorphParams, SynthParams
    from videomorphing_tpu_torch.models.image_morph import ImageMorpher

    morpher = ImageMorpher(*pair.params((MorphParams, SynthParams), config("pair_1k")), "cpu")
    a, b = inputs.make_clips(1, H, W, SEED, "cpu")
    art = morpher.solve(a[0], b[0], user_points())
    return morpher.render(a[0], b[0], art, TIMES)


def morph_clips():
    from videomorphing_tpu_torch import api
    from videomorphing_tpu_torch.config import MorphParams, SynthParams, VideoParams

    mp, sp, vp = pair.params((MorphParams, SynthParams, VideoParams), config("video_1080p"))
    a, b = inputs.make_clips(3, H, W, SEED, "cpu")
    return api.morph_clips(a, b, user_points(), mp=mp, sp=sp, vp=vp, render=True, device="cpu").frames


def batch_step():
    from videomorphing_tpu_torch.config import MorphParams, SynthParams
    from videomorphing_tpu_torch.parallel.batch import make_batch_step
    from videomorphing_tpu_torch.parallel.mesh import make_mesh

    mp, sp = pair.params((MorphParams, SynthParams), config("pair_1k"))
    step = make_batch_step(mp, sp, make_mesh((1,), ("batch",), devices=["cpu"]), (H, W), n_out=len(TIMES))
    a, b = inputs.make_clips(1, H, W, SEED, "cpu")
    return step(a, b, user_points()[None], TIMES[None])[0]


ENTRIES = {
    "ImageMorpher.solve.render": image_morpher,
    "api.morph_clips": morph_clips,
    "parallel.batch.make_batch_step": batch_step,
}
SOUND = {}


def sound(entry: str) -> torch.Tensor:
    """The entry's frames from the sound program (made once)."""
    if entry not in SOUND:
        SOUND[entry] = ENTRIES[entry]()
    return SOUND[entry]


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_entry_repeats_exactly(entry):
    # so that a fault's change is the fault's, not run-to-run noise
    assert torch.equal(ENTRIES[entry](), sound(entry))


@pytest.mark.parametrize("entry", sorted(ENTRIES))
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_fault_changes_each_entry(entry, fault, monkeypatch):
    before = sound(entry)
    FAULTS[fault](monkeypatch)
    after = ENTRIES[entry]()
    assert after.shape == before.shape and not torch.equal(after, before)


def test_a_planted_fault_is_undone(monkeypatch):
    import videomorphing_tpu_torch.parallel.batch as batch
    import videomorphing_tpu_torch.synth.render as render

    original = render.render_frame
    with monkeypatch.context() as mp:
        FAULTS["altered"](mp)
        assert batch.render_frame is render.render_frame is not original
    assert batch.render_frame is render.render_frame is original


STUB = "stub_tiny.stub3"


def stub_checkout(tmp_path: Path) -> Path:
    """``BENCHMARK.json`` and the files under its paths, with a cell of kind
    ``stub`` added as new files and entries: a configuration cut to 36 x 44,
    a mix, the cell, and the cell's name appended to the workloads of the
    metrics that the pair cells report."""
    root = tmp_path / "checkout"
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for p in spec["paths"]:
        shutil.copytree(ROOT / p, root / p, ignore=shutil.ignore_patterns("__pycache__"))
    cfg = {**config("pair_1k"), "name": "stub_tiny", "kind": "stub", "height": H, "width": W,
           "reduced": ["height", "width"]}
    (root / "vmbench" / "configs" / "stub_tiny.json").write_text(json.dumps(cfg, indent=1))
    mix = {"why": "2 pairs in turn, 3 frames each", "pool": 2, "frames": 3, "points": 4,
           "trace_morphs": 1, "check_morphs": 1, "check_within": 2}
    (root / "vmbench" / "mixes" / "stub3.json").write_text(json.dumps(mix, indent=1))
    spec["configs"].append({"name": "stub_tiny", "source": "pair_1k cut to 36 x 44", "file": "vmbench/configs/stub_tiny.json",
                            "reduced": ["height", "width"], "why": "a kind the harness has never seen"})
    spec["workloads"].append({"name": STUB, "config": "stub_tiny", "traffic": "stub3", "chips": 1,
                              "why": "closed loop, one client, 2 pairs in turn"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "pair_1k.points4" in m.get("workloads", []):
            m["workloads"].append(STUB)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=2))
    return root


@pytest.fixture
def stub(tmp_path, monkeypatch):
    """The stub checkout, its kind's module registered, and the harness
    reading its mixes and kernel-name lists from it, as a run from the
    checkout would."""
    root = stub_checkout(tmp_path)
    kind = types.ModuleType("vmbench.kinds.stub")
    kind.Program, kind.check = pair.Program, pair.check
    monkeypatch.setitem(sys.modules, "vmbench.kinds.stub", kind)
    monkeypatch.setattr(run, "HERE", root / "vmbench")
    return root


def test_a_new_kind_passes_the_contract(stub):
    spec = json.loads((stub / "BENCHMARK.json").read_text())
    assert STUB in contract.cells(spec)
    contract.check_all(spec, stub)


@pytest.mark.parametrize("trace", [0, 1])
def test_a_new_kind_runs_correct(stub, trace):
    cell = run.load_cell(stub, STUB)
    assert cell.config["kind"] == "stub" and cell.mix["pool"] == 2
    res = run.run_cell(cell, SEED, 0.0, bool(trace), "cpu")
    assert res["correct"] is True, res["check"]
    if trace:
        assert "solve_ms_per_morph" in res["metrics"]
    else:
        assert {"frames_per_s", "morph_s_p90", "setup_s"} == set(res["metrics"])


def test_a_new_kind_is_not_correct_under_a_fault(stub, monkeypatch):
    FAULTS["stale"](monkeypatch)
    assert run.run_cell(run.load_cell(stub, STUB), SEED, 0.0, False, "cpu")["correct"] is False


def test_the_contract_refuses_a_kind_without_a_check(stub, monkeypatch):
    monkeypatch.delattr(sys.modules["vmbench.kinds.stub"], "check")
    with pytest.raises(AttributeError):
        contract.check_cell(stub, STUB)


@pytest.mark.parametrize("listed, in_file", [
    (["height"], ["height", "width"]),  # the two lists differ
    (["channels"], ["channels"]),  # a width
    (["head_dim"], ["head_dim"]),
    (["a key"], ["a key"]),  # not a name
])
def test_the_contract_refuses_a_bad_reduced(stub, listed, in_file):
    spec = json.loads((stub / "BENCHMARK.json").read_text())
    next(c for c in spec["configs"] if c["name"] == "stub_tiny")["reduced"] = listed
    path = stub / "vmbench" / "configs" / "stub_tiny.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), "reduced": in_file}))
    with pytest.raises(AssertionError):
        contract.check_configs(spec, stub)
