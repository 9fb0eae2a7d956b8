"""Nothing the benchmark runs is JAX or the JAX package: the run's check
compares whole top-level module names, and no source under kbench/ (tests
aside) imports them or reads the old benchmark."""
import ast
import sys
from pathlib import Path

import pytest

from kbench import run

KBENCH = Path(__file__).resolve().parents[1]
SOURCES = [p for p in KBENCH.rglob("*.py") if "tests" not in p.parts]


@pytest.mark.parametrize("name,bad", [("repro_torch", False), ("repro_torch.serving", False),
                                      ("reprox", False), ("repro", True), ("repro.models", True),
                                      ("jax", True), ("jax._src.core", True), ("jaxlib", True),
                                      ("jaxtyping", False), ("flax.linen", True)])
def test_forbidden_compares_whole_top_level_names(monkeypatch, name, bad):
    monkeypatch.setitem(sys.modules, name, object())
    assert (name in run.forbidden_modules()) is bad


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(KBENCH)))
def test_sources_import_no_jax_and_no_old_benchmark(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro", "benchmarks"}
    text = path.read_text()
    assert "BENCH_workloads" not in text and "benchmarks/" not in text


def test_reference_imports_nothing_of_the_program():
    for path in (KBENCH / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "contextlib", "math", "typing", "torch"}, path
