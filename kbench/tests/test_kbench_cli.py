"""The command line without a card: exit code 2, no result line."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def test_no_card_no_result():
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"}
    p = subprocess.run([sys.executable, "kbench/run.py", "--workload", "minicpm-2b.closed16",
                        "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 2, p.stderr
    assert p.stdout.strip() == ""
    assert "needs 1 CUDA card" in p.stderr


def test_every_cell_resolves():
    sys.path.insert(0, str(ROOT))
    from kbench.spec import load_cell, reader

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = load_cell(bench, w["name"])
        assert cell.config["name"] == w["config"]
        for m in cell.end_to_end + cell.per_layer:
            assert callable(reader(m["name"]))
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique(key):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [e["name"] for e in bench[key]]
    assert len(names) == len(set(names))
