"""`repro_torch.analysis` — project-specific static invariants, machine-checked.

    python -m repro_torch.analysis src/repro_torch     # text findings, exit 1 if any
    python -m repro_torch.analysis --select RPA001 --format json src/repro_torch
    python -m repro_torch.analysis --write-schema      # record a deliberate schema change

The port's copy of ``repro.analysis``: the same checkers, codes and pragma
syntax, patrolling ``src/repro_torch/`` (``scopes.py``), with RPA004 counting
the port's own tests and RPA005 holding the port's producers against the
port's committed schema. Checkers (see DESIGN.md §analysis for the full
contract of each):

    RPA001  clock hygiene    no wall-clock reads outside serving/clock.py
    RPA002  rng discipline   only explicitly-seeded Generators in decision paths
                             (numpy's and torch's)
    RPA003  async safety     no blocking calls in the asyncio serving modules
    RPA004  registry coverage  every registered name tested + documented
    RPA005  metrics schema   summary()/cell key sets match the committed schema
    RPA000  (framework)      file does not parse — reported, never fatal
    RPA900  (framework)      suppression pragma without a justification

Suppress a finding with an inline pragma carrying a justification::

    t0 = time.perf_counter()  # repro: allow[RPA001] intentional wall time
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence

from repro_torch.analysis.checkers import ALL_CHECKERS
from repro_torch.analysis.core import (
    Checker,
    Finding,
    Project,
    find_repo_root,
    load_project,
    run_checkers,
)

__all__ = [
    "ALL_CHECKERS",
    "Checker",
    "Finding",
    "Project",
    "analyze",
    "find_repo_root",
    "load_project",
    "run_checkers",
]


def analyze(
    paths: Sequence[str],
    select: Optional[Sequence[str]] = None,
    root: Optional[Path] = None,
) -> List[Finding]:
    """Run the full suite over `paths`; the library entry point the CLI and
    the repo-smoke test share."""
    project = load_project([Path(p) for p in paths], root=root)
    return run_checkers(project, [cls() for cls in ALL_CHECKERS], select=select)
