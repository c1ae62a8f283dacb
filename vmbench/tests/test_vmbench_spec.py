"""``BENCHMARK.json`` keeps to the benchmark's contract, and every cell
resolves to its files: its configuration, its mix, its kind's module, the readers
of its per-layer metrics and the kernel-name lists they read. The checks
are ``contract``'s, which hold a cell of any kind to the same rules."""

import json
from pathlib import Path

import pytest

import contract

from vmbench import run

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = contract.cells(SPEC)


def test_top_level_keys_and_size():
    contract.check_top_level(SPEC, ROOT)


def test_command_and_paths():
    contract.check_command_and_paths(SPEC, ROOT)


def test_run_seconds_fit_a_full_check_of_24_cells():
    contract.check_run_seconds(SPEC, ROOT)


def test_names_are_unique_and_well_formed():
    contract.check_names(SPEC, ROOT)


def test_configs():
    contract.check_configs(SPEC, ROOT)


def test_workloads():
    contract.check_workloads(SPEC, ROOT)


def test_metrics():
    contract.check_metrics(SPEC, ROOT)


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_and_reports_enough(name):
    contract.check_cell(ROOT, name)


def test_an_unknown_cell_does_not_resolve(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(SPEC))
    with pytest.raises(KeyError):
        run.load_cell(tmp_path, "no_such.cell")
    with pytest.raises(OSError):  # the configuration's file is not in this directory
        run.load_cell(tmp_path, CELLS[0])
