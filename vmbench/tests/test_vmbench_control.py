"""On the card, at each cell's own size: the sound program's readings of
the numbers compared, and the control's. The control is the program with
its own lower-precision path switched on, the step that would tempt a
later change: the bfloat16 pack (``pack_dtype="bfloat16"``) for the
solve's float32 sweeps, and TF32 for the synthesis's float32 matrix
products (the DCT blend), where the configurations state float32 with TF32
off. ``correct`` has to come out true for every sound seed and false for
every control seed, and false for every seed of the program with a fault
planted (``faults.stale``: the solve returns a stale field beside its true
statistics). Each run is a short window of the cell's own load, checked as
a benchmark run checks it; every reading is printed.

    python3 -m pytest vmbench/tests/test_vmbench_control.py -m card -s    # on the card
"""

import json
from pathlib import Path

import pytest
import torch

from faults import FAULTS

from vmbench import run

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SOUND_SEEDS = tuple(4000000000 + 7919 * k for k in range(12))
CONTROL_SEEDS = (4100000017, 4100000033, 4100000051)
FAULT_SEEDS = (4200000011, 4200000029, 4200000053)


def control(cell):
    morph = {**cell.config["morph"], "pack_dtype": "bfloat16"}
    return cell._replace(config={**cell.config, "morph": morph})


def tf32(on: bool) -> None:
    import videomorphing_tpu_torch.device  # noqa: F401  (its import turns TF32 off)

    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def readings(tag, name, cell, seeds, device, on_tf32=False):
    """``correct`` of one short run of ``cell`` on each seed, each run's
    numbers printed under ``tag``."""
    out = []
    for seed in seeds:
        tf32(on_tf32)
        res = run.run_cell(cell, seed, 1.0, False, device)
        print(tag, name, seed, json.dumps(res["check"]), flush=True)
        out.append(res["correct"])
    return out


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_sound_program_is_correct(card, name):
    assert readings("SOUND", name, run.load_cell(ROOT, name), SOUND_SEEDS, card) == [True] * len(SOUND_SEEDS)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(card, name):
    try:
        got = readings("CONTROL", name, control(run.load_cell(ROOT, name)), CONTROL_SEEDS, card, on_tf32=True)
    finally:
        tf32(False)
    assert got == [False] * len(CONTROL_SEEDS)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_stale_field_is_not_correct(card, name, monkeypatch):
    FAULTS["stale"](monkeypatch)
    assert readings("STALE", name, run.load_cell(ROOT, name), FAULT_SEEDS, card) == [False] * len(FAULT_SEEDS)
