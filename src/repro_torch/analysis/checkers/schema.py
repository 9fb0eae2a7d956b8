"""RPA005 — metrics-schema drift.

CI's workloads-smoke and bench-gate jobs parse the JSON that
`ServeSession.summary()`, `RouterSession.summary()`, and the harness cell
builders emit (the port's producers emit the same JSON);
`benchmarks/check_regression.py` diffs committed records of it. Those
consumers live in other files, other jobs, other commits — so a renamed or
dropped key is a contract break that no unit in the producing module will
catch. This checker extracts the *key fingerprint* of each
producer from its AST and diffs it against the committed
`src/repro_torch/analysis/schema/metrics_schema.json`: the contract can only
change together with an explicit schema update
(``python -m repro_torch.analysis --write-schema``), which makes the change
visible in review.

A key fingerprint is the union, over the producer's body, of: keyword names
of ``dict(...)`` calls, string keys of dict literals, string keys assigned
via subscript (``out["k"] = ...``), and keyword names of ``.update(...)``
calls. It is a drift detector, not a precise schema — nested and top-level
keys are pooled deliberately, so *any* key change anywhere in the producer
trips the diff.

The port's ``SPECS`` are the reference's entries, keys and symbol paths with
files under ``src/repro_torch/``, and its committed schema's ``entries``
equal the reference's: a key that differs is a fault of the port, to be
repaired in the port, not a schema update.
"""
from __future__ import annotations

import json
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

import ast

from repro_torch.analysis.core import Finding, Project

SCHEMA_REL = "src/repro_torch/analysis/schema/metrics_schema.json"

# (entry key, repo-relative file, symbol path, extraction mode)
SPECS: Tuple[Tuple[str, str, Tuple[str, ...], str], ...] = (
    ("serving.SessionMetrics", "src/repro_torch/serving/session.py", ("SessionMetrics",), "fields"),
    ("serving.ServeSession.summary", "src/repro_torch/serving/session.py", ("ServeSession", "summary"), "keys"),
    ("serving.RouterSession.summary", "src/repro_torch/serving/router.py", ("RouterSession", "summary"), "keys"),
    ("serving.RouterSession.prefix_summary", "src/repro_torch/serving/router.py", ("RouterSession", "prefix_summary"), "keys"),
    ("serving.HandoffMetrics", "src/repro_torch/serving/disagg.py", ("HandoffMetrics",), "fields"),
    ("serving.DisaggSession.summary", "src/repro_torch/serving/disagg.py", ("DisaggSession", "summary"), "keys"),
    ("serving.DisaggSession.handoff_summary", "src/repro_torch/serving/disagg.py", ("DisaggSession", "handoff_summary"), "keys"),
    ("sim.Attainment", "src/repro_torch/sim/metrics.py", ("Attainment",), "fields"),
    ("sim.summarize", "src/repro_torch/sim/metrics.py", ("summarize",), "keys"),
    ("workloads.cell_report", "src/repro_torch/workloads/harness.py", ("_cell_report",), "keys"),
    ("workloads.evaluate_cell", "src/repro_torch/workloads/harness.py", ("evaluate_cell",), "keys"),
    ("workloads.router_cell_block", "src/repro_torch/workloads/harness.py", ("router_cell_block",), "keys"),
    ("workloads.disagg_cell_block", "src/repro_torch/workloads/harness.py", ("disagg_cell_block",), "keys"),
    ("workloads.churn_cell_block", "src/repro_torch/workloads/harness.py", ("churn_cell_block",), "keys"),
    ("serving.FleetSession.summary", "src/repro_torch/serving/fleetctl.py", ("FleetSession", "summary"), "keys"),
    ("obs.counters_from_events", "src/repro_torch/obs/events.py", ("counters_from_events",), "keys"),
    ("obs.attainment_from_events", "src/repro_torch/obs/slo.py", ("attainment_from_events",), "keys"),
    ("obs.windowed_slo", "src/repro_torch/obs/slo.py", ("windowed_slo",), "keys"),
    ("obs.trace_cell_block", "src/repro_torch/obs/slo.py", ("trace_cell_block",), "keys"),
)


def _find_symbol(tree: ast.Module, path: Sequence[str]) -> Optional[ast.AST]:
    node: ast.AST = tree
    for name in path:
        body = getattr(node, "body", [])
        node = next(
            (
                n
                for n in body
                if isinstance(n, (ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef))
                and n.name == name
            ),
            None,
        )
        if node is None:
            return None
    return node


def _dataclass_fields(cls: ast.ClassDef) -> Set[str]:
    return {
        s.target.id
        for s in cls.body
        if isinstance(s, ast.AnnAssign) and isinstance(s.target, ast.Name)
    }


def _key_fingerprint(fn: ast.AST) -> Set[str]:
    keys: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            func = node.func
            is_dict = isinstance(func, ast.Name) and func.id == "dict"
            is_update = isinstance(func, ast.Attribute) and func.attr == "update"
            if is_dict or is_update:
                keys.update(kw.arg for kw in node.keywords if kw.arg is not None)
        elif isinstance(node, ast.Dict):
            keys.update(
                k.value for k in node.keys
                if isinstance(k, ast.Constant) and isinstance(k.value, str)
            )
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if (
                    isinstance(t, ast.Subscript)
                    and isinstance(t.slice, ast.Constant)
                    and isinstance(t.slice.value, str)
                ):
                    keys.add(t.slice.value)
    return keys


def extract_schema(project: Project, specs=SPECS) -> Dict[str, object]:
    """The current tree's schema: entry key -> sorted key list (or an
    ``{"error": ...}`` marker when the producer cannot be located)."""
    entries: Dict[str, object] = {}
    for key, rel, path, mode in specs:
        sf = project.get(rel)
        if sf is None or sf.tree is None:
            entries[key] = {"error": f"{rel} not found or unparseable"}
            continue
        sym = _find_symbol(sf.tree, path)
        if sym is None:
            entries[key] = {"error": f"{'.'.join(path)} not found in {rel}"}
            continue
        got = _dataclass_fields(sym) if mode == "fields" else _key_fingerprint(sym)
        entries[key] = sorted(got)
    return {"version": 1, "entries": entries}


class MetricsSchemaChecker:
    code = "RPA005"
    description = (
        "summary()/cell-builder key sets must match the committed "
        "metrics_schema.json (update via `python -m repro_torch.analysis --write-schema`)"
    )

    # overridable for fixture tests
    schema_rel = SCHEMA_REL
    specs = SPECS

    def run(self, project: Project) -> Iterator[Finding]:
        schema_path = project.root / self.schema_rel
        if not schema_path.exists():
            yield Finding(
                self.schema_rel, 1, self.code,
                "committed metrics schema is missing; generate it with "
                "`python -m repro_torch.analysis --write-schema`",
            )
            return
        committed = json.loads(schema_path.read_text(encoding="utf-8")).get("entries", {})
        current = extract_schema(project, self.specs)["entries"]

        for key, rel, path, _mode in self.specs:
            got = current.get(key)
            sf = project.get(rel)
            sym = _find_symbol(sf.tree, path) if sf is not None and sf.tree is not None else None
            line = getattr(sym, "lineno", 1)
            if isinstance(got, dict):  # locate error
                yield Finding(rel, 1, self.code, f"schema entry '{key}': {got['error']}")
                continue
            want = committed.get(key)
            if want is None:
                yield Finding(
                    rel, line, self.code,
                    f"producer '{key}' has no entry in {self.schema_rel}; "
                    "re-run --write-schema to record it",
                )
                continue
            added = sorted(set(got) - set(want))
            removed = sorted(set(want) - set(got))
            for k in added:
                yield Finding(
                    rel, line, self.code,
                    f"'{key}' now emits key '{k}' not in the committed schema — "
                    "downstream CI consumers parse this JSON; update "
                    f"{self.schema_rel} deliberately (--write-schema)",
                )
            for k in removed:
                yield Finding(
                    rel, line, self.code,
                    f"'{key}' no longer emits key '{k}' that the committed "
                    "schema promises — this breaks the bench-gate/workloads "
                    f"JSON contract; update {self.schema_rel} deliberately",
                )
        for key in sorted(set(committed) - {s[0] for s in self.specs}):
            yield Finding(
                self.schema_rel, 1, self.code,
                f"schema entry '{key}' has no extraction spec; remove it or "
                "add a spec in repro_torch.analysis.checkers.schema",
            )
