"""RPA001 — clock hygiene.

The engine, sim, policies, and workloads compute TTFT/TPOT/slack from an
injectable `Clock` (serving/clock.py). A direct wall-clock read anywhere in
those packages makes scheduling decisions time-dependent and voids the
ManualClock parity contracts (sync session == async frontend == 1-replica
router, bit for bit) without failing a single test — the parity tests all
run on ManualClock and never see the stray read. This checker makes the
injection boundary a machine-checked fact.
"""
from __future__ import annotations

from typing import Iterator

import ast

from repro_torch.analysis.core import Finding, Project, import_aliases, resolve_call
from repro_torch.analysis.scopes import CLOCK_SCOPE

BANNED = {
    "time.time",
    "time.time_ns",
    "time.monotonic",
    "time.monotonic_ns",
    "time.perf_counter",
    "time.perf_counter_ns",
    "time.process_time",
    "time.process_time_ns",
    "datetime.datetime.now",
    "datetime.datetime.utcnow",
    "datetime.datetime.today",
    "datetime.date.today",
}


class ClockHygieneChecker:
    code = "RPA001"
    description = (
        "no wall-clock reads outside serving/clock.py — all timing flows "
        "through the injectable Clock"
    )

    def run(self, project: Project) -> Iterator[Finding]:
        for sf in project.iter_files(CLOCK_SCOPE.include, CLOCK_SCOPE.exclude):
            if sf.tree is None:
                continue
            aliases = import_aliases(sf.tree)
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Call):
                    continue
                target = resolve_call(node, aliases)
                if target in BANNED:
                    yield Finding(
                        sf.rel,
                        node.lineno,
                        self.code,
                        f"wall-clock read `{target}()` in a deterministic-core "
                        "package; read time through the injectable Clock "
                        "(repro_torch.serving.clock) instead",
                    )
