"""On the card: one short run of each cell from the command line, and the
run's refusal in a directory that holds only the benchmark's own files.
Marked ``cuda``; each test decides inside itself whether there is a card.

    python -m pytest -m cuda kbench/tests/test_kbench_cuda.py
"""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
pytestmark = pytest.mark.cuda
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _run(cwd, workload, trace=0, seconds=5):
    return subprocess.run([sys.executable, "kbench/run.py", "--workload", workload,
                           "--seed", str(2**31 + 99), "--seconds", str(seconds),
                           "--trace", str(trace)],
                          cwd=cwd, capture_output=True, text=True, timeout=1200)


@pytest.mark.parametrize("workload", CELLS)
def test_short_run_is_correct(workload):
    _need_card()
    p = _run(ROOT, workload)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, p.stderr[-4000:]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    assert list(out)[-1] == "checks"


def test_benchmark_files_alone_do_not_run(tmp_path):
    _need_card()
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "kbench", tmp_path / "kbench")
    p = _run(tmp_path, CELLS[0])
    assert p.returncode != 0
    assert p.stdout.strip() == ""
