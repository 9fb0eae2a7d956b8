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


def _imports(path: Path, kbench: Path = KBENCH):
    """Every module ``path`` imports, relative imports resolved from its
    package under ``kbench``'s parent (``kbench/reference/x.py``'s
    ``from . import model`` is ``kbench.reference``)."""
    package = path.relative_to(kbench.parent).parts[:-1]
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = package[:len(package) - node.level + 1] if node.level else ()
            yield ".".join(base + ((node.module,) if node.module else ()))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(KBENCH)))
def test_sources_import_no_jax_and_no_old_benchmark(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro", "benchmarks"}
    text = path.read_text()
    assert "BENCH_workloads" not in text and "benchmarks/" not in text


REFERENCE_MAY_IMPORT = {"__future__", "contextlib", "math", "typing", "torch"}


def _reference_may_import(module: str) -> bool:
    """The standard modules above, torch, and the helpers of another
    reference (``kbench.reference.*``); nothing of the program or the rest
    of the harness."""
    return (module.split(".")[0] in REFERENCE_MAY_IMPORT
            or module == "kbench.reference" or module.startswith("kbench.reference."))


def test_reference_imports_nothing_of_the_program():
    for path in (KBENCH / "reference").rglob("*.py"):
        bad = [m for m in _imports(path) if not _reference_may_import(m)]
        assert not bad, (path, bad)


@pytest.mark.parametrize("module,ok", [("torch.nn", True), ("kbench.reference.model", True),
                                       ("kbench.reference", True), ("kbench.yardstick", False),
                                       ("kbench", False), ("kbench.referencex", False),
                                       ("repro_torch.models", False), ("numpy", False)])
def test_a_reference_may_import_other_references_and_nothing_else_new(module, ok):
    assert _reference_may_import(module) is ok


def test_relative_imports_resolve_from_the_package(tmp_path):
    path = tmp_path / "kbench" / "reference" / "x.py"
    path.parent.mkdir(parents=True)
    path.write_text("from . import model\nfrom .model import _rms\nfrom .. import yardstick\n")
    assert list(_imports(path, tmp_path / "kbench")) == \
        ["kbench.reference", "kbench.reference.model", "kbench"]
