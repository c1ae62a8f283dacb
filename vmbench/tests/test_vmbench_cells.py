"""Every cell of ``BENCHMARK.json`` at a tiny size end to end through the
harness on the CPU (``run.run_cell`` with ``device="cpu"`` skips the look
for a card), sound and with the timed path broken underneath: ``correct``
has to come out true for the sound program and false for each fault a cell
can have. A cell without an entry in ``TINY`` takes the sizes of
``tiny_sizes``."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from faults import FAULTS

from vmbench import run

ROOT = Path(__file__).resolve().parents[2]
TINY = {
    "pair_1k.points4": ({"height": 36, "width": 44}, {"pool": 2, "frames": 3}),
    "pair_1k.render120": ({"height": 36, "width": 44}, {"pool": 2, "frames": 4}),
    "video_1080p.clip30": ({"height": 36, "width": 44, "frames": 3}, {"pool": 2}),
}
CELLS = sorted(w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"])
SEED = 2**31 + 12345


def tiny_sizes(config, mix):
    """36 x 44, 3 frames where the configuration has frames; a pool of 2, and
    at most 4 frames where the mix has frames."""
    over = {"height": 36, "width": 44, **({"frames": 3} if "frames" in config else {})}
    mover = {"pool": 2, **({"frames": min(int(mix["frames"]), 4)} if "frames" in mix else {})}
    return over, mover


def tiny(name):
    cell = run.load_cell(ROOT, name)
    over, mover = TINY.get(name) or tiny_sizes(cell.config, cell.mix)
    return cell._replace(config={**cell.config, **over}, mix={**cell.mix, **mover})


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_sound_cell_is_correct(name, trace):
    cell = tiny(name)
    res = run.run_cell(cell, SEED, 0.0, bool(trace), "cpu")
    assert res["correct"] is True
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "check" and res["check"]
    assert all(c["value"] <= c["limit"] for c in res["check"].values())
    json.dumps(res)  # one JSON object
    if trace:
        per_layer = {m["name"] for m in cell.per_layer}
        assert res["metrics"] and set(res["metrics"]) <= per_layer
        assert "solve_ms_per_morph" in res["metrics"] or "solve_ms_per_morph" not in per_layer
    else:
        assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(m["value"] > 0 for m in res["metrics"].values())


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_cell_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = run.run_cell(tiny(name), SEED, 0.0, False, "cpu")
    assert res["correct"] is False, res["check"]


def test_main_without_a_card_prints_no_result(monkeypatch, capsys):
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "pair_1k.points4", "--seed", "1", "--seconds", "1"]) == 3
    assert capsys.readouterr().out == ""


def test_main_outside_a_checkout_prints_no_result(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert run.main(["--workload", "pair_1k.points4", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_same_seed_same_inputs_other_seed_other_inputs():
    from vmbench.kinds import pair

    cell = tiny("pair_1k.points4")
    a = pair.pool_inputs(cell.config, cell.mix, SEED, 1, "cpu")[0]
    b = pair.pool_inputs(cell.config, cell.mix, SEED, 1, "cpu")[0]
    c = pair.pool_inputs(cell.config, cell.mix, SEED + 1, 1, "cpu")[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not np.array_equal(pair.pool_inputs(cell.config, cell.mix, SEED, 0, "cpu")[0].numpy(), a.numpy())
