"""What a cell is made of, found by name: ``BENCHMARK.json``'s entry, the
configuration file, the traffic mix, the plain reference the configuration
names and the metric readers.

    kbench/configs/<config>.json    sizes, engine settings, the correctness limit
    kbench/traffic/<traffic>.json   parameters of the one generator
    kbench/reference/<name>.py      ``logits_at``, named by the configuration's ``reference``
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
from kbench.yardstick import layer_windows

KBENCH = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    mix: Mix
    end_to_end: List[Dict]  # BENCHMARK.json entries this cell reports
    per_layer: List[Dict]
    root: Path  # the folder its files were found under


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
    reference(config, root)  # a configuration that names no reference fails before a run
    layer_windows(config)
    mix = Mix.load(root / "traffic" / f"{w['traffic']}.json")
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config=config,
        mix=mix,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, workload)],
        root=root,
    )


def _load(path: Path, module: str):
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str) -> Callable[[Dict], Optional[float]]:
    """The ``read`` function of ``metrics/<name>.py``."""
    return _load(KBENCH / "metrics" / f"{name}.py", "kbench_metric_" + name.replace(".", "_")).read


def reference(config: Dict, root: Optional[Path] = None) -> Callable:
    """The ``logits_at`` of ``reference/<name>.py`` under ``root`` (default:
    this package's folder), ``name`` being the configuration's
    ``reference``. Raises ``ValueError``, naming the configuration, where
    it names none or one that is not there."""
    folder = (root or KBENCH) / "reference"
    known = sorted(p.stem for p in folder.glob("*.py") if p.stem != "__init__")
    name = config.get("reference")
    if name not in known:
        said = "names no reference" if name is None else f"names the reference {name!r}"
        raise ValueError(f"configuration {config.get('name')!r} {said}; the modules under "
                         f"{folder} are {known}")
    return _load(folder / f"{name}.py", "kbench_reference_" + name.replace(".", "_")).logits_at
