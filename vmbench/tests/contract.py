"""The benchmark's contract as checks of one ``BENCHMARK.json`` (``spec``,
already parsed) and the checkout it lies in (``root``): the repo's own
in ``test_vmbench_spec.py``, a checkout with a cell of a kind the harness
has never seen in ``test_vmbench_new_kind.py``. Each check raises
``AssertionError`` (or the error of a file that does not resolve)."""

import importlib
import inspect
import json
import re
from pathlib import Path

from vmbench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
MODULE = re.compile(r"^[a-z_][a-z0-9_]*$")
# keys that name a width, which no cut may change: the contract's list, and
# a record's channels
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion|experts_per|channels")


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def cells(spec) -> list:
    return [w["name"] for w in spec["workloads"]]


def check_top_level(spec, root: Path):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((root / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def check_command_and_paths(spec, root: Path):
    assert 1 <= len(spec["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in spec["paths"])
    assert all((root / p).is_dir() for p in spec["paths"])
    assert 1 <= len(spec["command"]) <= 32 and all(line(w) for w in spec["command"])
    assert not any(w.startswith("/") or ".." in w for w in spec["command"])


def check_run_seconds(spec, root: Path):
    rs = spec["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def check_names(spec, root: Path):
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in spec[group]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    metrics = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(metrics) == len(set(metrics))


def check_reduced(entry: dict, config: dict):
    """``reduced`` lists the keys cut from the source, the same in
    ``BENCHMARK.json`` and in the configuration's file: each a name, none a
    width, at most 16; an empty list is a configuration run as published."""
    reduced = entry["reduced"]
    assert isinstance(reduced, list) and len(reduced) <= 16 and len(reduced) == len(set(reduced))
    assert all(NAME.match(k) and not WIDTH.search(k) for k in reduced), reduced
    assert config["reduced"] == reduced


def check_kind(kind: str):
    """``vmbench.kinds.<kind>`` keeps the contract that
    ``vmbench/kinds/__init__.py`` states."""
    assert MODULE.match(kind), kind
    mod = importlib.import_module(f"vmbench.kinds.{kind}")
    program = mod.Program
    assert inspect.isclass(program)
    inspect.signature(program).bind("config", "mix", "seed", "device")
    inspect.signature(program.morph).bind("self", "item", "spans")
    inspect.signature(program.release).bind("self")
    names = program.span_names
    assert isinstance(names, tuple) and all(isinstance(n, str) and n for n in names)
    assert callable(mod.check)
    inspect.signature(mod.check).bind("config", "mix", "seed", "device", "item", "outputs")


def check_configs(spec, root: Path):
    assert 1 <= len(spec["configs"]) <= 24
    used = {w["config"] for w in spec["workloads"]}
    files = [c["file"] for c in spec["configs"]]
    assert len(files) == len(set(files))
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and line(c["source"]) and line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in spec["paths"])
        cfg = json.loads((root / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        check_reduced(c, cfg)
        check_kind(cfg["kind"])
        assert all(isinstance(v, (int, float)) and v > 0 for v in cfg["limits"].values())


def check_workloads(spec, root: Path):
    names = cells(spec)
    assert 1 <= len(names) <= 24
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in spec["workloads"])
    assert four <= max(1, len(names) // 4)
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and line(w["why"]) and NAME.match(w["traffic"])
        mix = json.loads((root / "vmbench" / "mixes" / f"{w['traffic']}.json").read_text())
        assert {"pool", "points", "trace_morphs", "check_morphs", "check_within"} <= set(mix)


def check_metrics(spec, root: Path):
    names = cells(spec)
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    assert 1 <= len(spec["per_layer"]) <= 128
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", names)) <= set(names)
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and line(m["layer"])
        assert m["source"] in ("host_clock", "device_trace", "program_span", "program_counter")
        assert m["moves"] in e2e and set(m["workloads"]) <= set(names)
        moved = set(e2e[m["moves"]].get("workloads", names))
        assert set(m["workloads"]) <= moved
        assert callable(importlib.import_module(f"vmbench.metrics.{m['name']}").read)


def check_cell(root: Path, name: str):
    """The cell resolves to its files, its kind keeps the kinds' contract,
    and it reports ``setup_s``, another end-to-end metric and a per-layer
    metric; the kernel-name lists the readers read are there."""
    cell = run.load_cell(root, name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    check_kind(cell.config["kind"])
    for names in ("sweep_grad", "sweeps", "followers"):
        assert run.Reading.kernel_names(names)


CHECKS = (check_top_level, check_command_and_paths, check_run_seconds, check_names, check_configs,
          check_workloads, check_metrics)


def check_all(spec, root: Path):
    for check in CHECKS:
        check(spec, root)
    for name in cells(spec):
        check_cell(root, name)
