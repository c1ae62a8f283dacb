"""``BENCHMARK.json`` keeps to the benchmark's contract, and every cell
resolves to its files: its configuration, its mix, its kind's module, the readers
of its per-layer metrics and the kernel-name lists they read."""

import importlib
import json
import re
from pathlib import Path

import pytest

from vmbench import run

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(SPEC["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in SPEC["paths"])
    assert all((ROOT / p).is_dir() for p in SPEC["paths"])
    assert 1 <= len(SPEC["command"]) <= 32 and all(line(w) for w in SPEC["command"])
    assert not any(w.startswith("/") or ".." in w for w in SPEC["command"])


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_are_unique_and_well_formed():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_configs():
    assert 1 <= len(SPEC["configs"]) <= 24
    used = {w["config"] for w in SPEC["workloads"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and line(c["source"]) and line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
        assert importlib.import_module(f"vmbench.kinds.{cfg['kind']}")
        assert all(isinstance(v, (int, float)) and v > 0 for v in cfg["limits"].values())


def test_workloads():
    assert 1 <= len(SPEC["workloads"]) <= 24
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and line(w["why"]) and NAME.match(w["traffic"])
        mix = json.loads((ROOT / "vmbench" / "mixes" / f"{w['traffic']}.json").read_text())
        assert {"pool", "points", "trace_morphs", "check_morphs", "check_within"} <= set(mix)


def test_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    assert 1 <= len(SPEC["per_layer"]) <= 128
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and line(m["layer"])
        assert m["source"] in ("host_clock", "device_trace", "program_span", "program_counter")
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        moved = set(e2e[m["moves"]].get("workloads", CELLS))
        assert set(m["workloads"]) <= moved
        assert callable(importlib.import_module(f"vmbench.metrics.{m['name']}").read)


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_and_reports_enough(name):
    cell = run.load_cell(ROOT, name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    assert cell.config["kind"] in ("pair", "video")
    for names in ("sweep_grad", "sweeps", "followers"):
        assert run.Reading.kernel_names(names)


def test_an_unknown_cell_does_not_resolve(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(SPEC))
    with pytest.raises(KeyError):
        run.load_cell(tmp_path, "no_such.cell")
    with pytest.raises(OSError):  # the configuration's file is not in this directory
        run.load_cell(tmp_path, CELLS[0])
