"""No module of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program; names are compared whole, by
their top level (``videomorphing_tpu_torch`` is not ``videomorphing_tpu``)."""

import ast
import sys
import types
from pathlib import Path

import pytest

from vmbench import run

BENCH = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "videomorphing_tpu"}


def imported_top_levels(path: Path) -> set:
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def modules(sub: str = ""):
    return sorted((BENCH / sub).rglob("*.py"))


@pytest.mark.parametrize("path", modules(), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported_top_levels(path) & NEVER


@pytest.mark.parametrize("path", modules("reference"), ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_program(path):
    found = imported_top_levels(path)
    assert not found & (NEVER | {"videomorphing_tpu_torch"})
    assert found <= {"vmbench", "torch", "numpy", "math", "functools", "dataclasses", "typing", "__future__"}


def test_the_scan_compares_whole_top_level_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import videomorphing_tpu_torch.api\nfrom videomorphing_tpu.config import X\n")
    assert imported_top_levels(p) == {"videomorphing_tpu_torch", "videomorphing_tpu"}


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "videomorphing_tpu_torch.fake", types.ModuleType("fake"))
    assert "videomorphing_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "videomorphing_tpu.fake", types.ModuleType("fake"))
    assert "videomorphing_tpu" in run.forbidden_modules()
