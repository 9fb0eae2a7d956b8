"""The port's static-analysis gate over the committed tree: torch twins of
tests/test_analysis_repo.py on ``src/repro_torch/`` through
``repro_torch.analysis`` (library and CLI), plus the port's committed
metrics schema, which ``--write-schema`` reproduces and whose entries equal
the reference's."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.analysis import ALL_CHECKERS, analyze, load_project  # noqa: E402
from repro_torch.analysis.checkers.schema import SCHEMA_REL, SPECS, extract_schema  # noqa: E402

REPO_ROOT = Path(__file__).resolve().parent.parent
PORT = REPO_ROOT / "src" / "repro_torch"
EVERY_CODE = ["RPA000", *(cls.code for cls in ALL_CHECKERS), "RPA900"]


def _cli(*args, cwd=REPO_ROOT):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        cwd=cwd,
        capture_output=True,
        text=True,
        env={"PYTHONPATH": str(REPO_ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=120,
    )


def test_committed_tree_is_clean():
    assert EVERY_CODE == ["RPA000", "RPA001", "RPA002", "RPA003", "RPA004", "RPA005", "RPA900"]
    findings = analyze([str(PORT)], root=REPO_ROOT, select=EVERY_CODE)
    assert findings == [], "unsuppressed findings:\n" + "\n".join(map(str, findings))
    assert analyze([str(PORT)], root=REPO_ROOT) == []  # no select: the same set


def test_cli_exits_zero_on_committed_tree():
    proc = _cli("src/repro_torch", "--select", ",".join(EVERY_CODE), "--format", "json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(proc.stdout)
    assert report["count"] == 0 and report["findings"] == []
    proc = _cli()  # the default path is the port
    assert proc.returncode == 0 and proc.stdout.strip() == "repro_torch.analysis: clean", (
        proc.stdout + proc.stderr)


def test_cli_exits_nonzero_on_violation(tmp_path):
    # a real violation through the real CLI: exit 1 + a parsable finding
    (tmp_path / "pyproject.toml").write_text("[project]\nname='fixture'\n")
    bad = tmp_path / "src" / "repro_torch" / "sim" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import time\nt = time.monotonic()\n")
    proc = _cli(str(tmp_path / "src"), "--select", "RPA001", "--format", "json")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    report = json.loads(proc.stdout)
    assert report["count"] == 1
    assert report["findings"][0]["code"] == "RPA001"
    assert report["findings"][0]["line"] == 2
    assert report["findings"][0]["file"] == "src/repro_torch/sim/bad.py"


def test_cli_exits_two_on_a_missing_path(tmp_path):
    proc = _cli(str(tmp_path / "nowhere"))
    assert proc.returncode == 2, proc.stdout + proc.stderr
    assert "no such path" in proc.stderr and proc.stdout == ""


def test_cli_degrades_gracefully_on_unparseable_file(tmp_path):
    (tmp_path / "pyproject.toml").write_text("[project]\nname='fixture'\n")
    bad = tmp_path / "src" / "repro_torch" / "sim" / "broken.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("def f(:\n    pass\n")
    proc = _cli(str(tmp_path / "src"), "--select", "RPA000,RPA001", "--format", "json")
    assert proc.returncode == 1, proc.stdout + proc.stderr  # reported, not crashed
    report = json.loads(proc.stdout)
    assert [f["code"] for f in report["findings"]] == ["RPA000"]
    assert report["findings"][0]["file"].endswith("broken.py")


def test_cli_list_names_all_checkers():
    proc = _cli("--list")
    assert proc.returncode == 0
    for code in ("RPA001", "RPA002", "RPA003", "RPA004", "RPA005"):
        assert code in proc.stdout
    assert len(proc.stdout.splitlines()) == 5


def test_committed_metrics_schema_matches_tree():
    """--write-schema must be a no-op on the committed tree (the RPA005
    clean check above implies this; asserting directly gives a sharper
    failure when only the schema file is stale)."""
    project = load_project([PORT], root=REPO_ROOT)
    current = extract_schema(project)
    committed = json.loads((REPO_ROOT / SCHEMA_REL).read_text())
    assert current == committed


def test_write_schema_reproduces_the_committed_schema(tmp_path):
    (tmp_path / "pyproject.toml").write_text("[project]\nname='fixture'\n")
    shutil.copytree(PORT, tmp_path / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "csrc", "*.json"))
    out = tmp_path / SCHEMA_REL
    assert not out.exists()
    proc = _cli("--write-schema", str(tmp_path / "src" / "repro_torch"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert out.read_bytes() == (REPO_ROOT / SCHEMA_REL).read_bytes()


def test_the_ports_schema_entries_equal_the_references():
    """The port's producers emit the reference's keys: 19 entries, the same
    symbols, key for key (a difference is a fault of the port)."""
    port = json.loads((REPO_ROOT / SCHEMA_REL).read_text())
    ref = json.loads((REPO_ROOT / "src/repro/analysis/schema/metrics_schema.json").read_text())
    assert port["version"] == ref["version"]
    assert port["entries"] == ref["entries"]
    assert len(SPECS) == len(port["entries"]) == 19
    from repro.analysis.checkers.schema import SPECS as REF_SPECS

    assert [(k, rel.replace("src/repro/", "src/repro_torch/", 1), path, mode)
            for k, rel, path, mode in REF_SPECS] == list(SPECS)
