"""What a cell is made of, found by name: ``BENCHMARK.json``'s entry, the
configuration file, the traffic mix and the metric readers.

    kbench/configs/<config>.json    sizes, engine settings, the correctness limit
    kbench/traffic/<traffic>.json   parameters of the one generator
    kbench/metrics/<metric>.py      ``read(record) -> float | None``

A later cell or metric is files and entries; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

from kbench.traffic.generator import Mix

KBENCH = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    mix: Mix
    end_to_end: List[Dict]  # BENCHMARK.json entries this cell reports
    per_layer: List[Dict]


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(bench: Dict, workload: str, root: Optional[Path] = None) -> Cell:
    """The cell ``workload`` of the benchmark description ``bench`` (the
    parsed ``BENCHMARK.json``); files are looked up under ``root``
    (default: this package's folder)."""
    root = root or KBENCH
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root.parent / cfg_entry["file"]).read_text())
    mix = Mix.load(root / "traffic" / f"{w['traffic']}.json")
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config=config,
        mix=mix,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, workload)],
    )


def reader(name: str) -> Callable[[Dict], Optional[float]]:
    """The ``read`` function of ``metrics/<name>.py``."""
    path = KBENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("kbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
