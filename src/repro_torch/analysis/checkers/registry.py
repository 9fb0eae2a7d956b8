"""RPA004 — registry coverage.

Every policy and scenario ships through a string-keyed registry
(`@register_prefill("kairos-urgency")`, `@register_scenario("bursty")`, …),
which is exactly what makes an *untested* or *undocumented* one invisible:
nothing imports it by symbol, so dead or broken registrants stay green
forever. This checker cross-references every name the port registers
against the port's own tests (``tests/test_torch_*.py``: a name that only a
reference test mentions exercises ``repro``'s policy, not the port's) and
the docs layer (DESIGN.md plus, when present, the
operator-facing docs/OPERATORS.md — a name appearing in either counts) — a
policy you can ship but nobody exercises, or exercise but nobody documents,
fails the build at its registration site.

Both registration forms count: the decorator form and the direct
factory-call form (``register_decode("x", flag=True)(Cls)``).

Matching is word-ish (name delimited by non-``[A-Za-z0-9_-]``), so
"kairos-slack" inside "kairos-slack-greedy" does **not** count as coverage
of "kairos-slack".
"""
from __future__ import annotations

import re
from typing import Dict, Iterator, List, Tuple

import ast

from repro_torch.analysis.core import Finding, Project, dotted
from repro_torch.analysis.scopes import SRC_SCOPE

REGISTER_FUNCS = (
    "register_prefill",
    "register_decode",
    "register_router",
    "register_deflection",
    "register_autoscaler",
    "register_scenario",
)


def _registrations(project: Project) -> List[Tuple[str, str, str, int]]:
    """(kind, name, file, line) for every registry call under src."""
    out: List[Tuple[str, str, str, int]] = []
    for sf in project.iter_files(SRC_SCOPE.include, SRC_SCOPE.exclude):
        if sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = dotted(node.func)
            if chain is None:
                continue
            kind = chain.split(".")[-1]
            if kind not in REGISTER_FUNCS:
                continue
            if not node.args or not isinstance(node.args[0], ast.Constant):
                continue
            name = node.args[0].value
            if isinstance(name, str):
                out.append((kind, name, sf.rel, node.lineno))
    return out


def _word_pattern(name: str) -> re.Pattern:
    return re.compile(rf"(?<![\w-]){re.escape(name)}(?![\w-])")


class RegistryCoverageChecker:
    code = "RPA004"
    description = (
        "every registered policy/scenario name must be referenced by at "
        "least one tests/test_torch_*.py file and documented in DESIGN.md or "
        "docs/OPERATORS.md"
    )

    # overridable for fixture tests; files that don't exist are skipped, but
    # at least one doc file must exist for the doc side of the check to pass
    tests_dir = "tests"
    tests_glob = "test_torch_*.py"  # the port's tests; the reference's cover repro
    doc_files = ("DESIGN.md", "docs/OPERATORS.md")

    def run(self, project: Project) -> Iterator[Finding]:
        regs = _registrations(project)
        if not regs:
            return
        tests_root = project.root / self.tests_dir
        test_texts: Dict[str, str] = {}
        if tests_root.is_dir():
            for p in sorted(tests_root.rglob(self.tests_glob)):
                test_texts[p.name] = p.read_text(encoding="utf-8")
        doc_texts = [
            (project.root / rel).read_text(encoding="utf-8")
            for rel in self.doc_files
            if (project.root / rel).exists()
        ]
        doc_label = " or ".join(self.doc_files)

        for kind, name, rel, line in regs:
            pat = _word_pattern(name)
            if not any(pat.search(t) for t in test_texts.values()):
                yield Finding(
                    rel, line, self.code,
                    f"{kind}('{name}') has no reference in "
                    f"{self.tests_dir}/{self.tests_glob} — "
                    "a registered-but-untested policy can rot silently; add a "
                    "test that exercises it by name",
                )
            if not any(pat.search(t) for t in doc_texts):
                yield Finding(
                    rel, line, self.code,
                    f"{kind}('{name}') is not documented in {doc_label} — "
                    "add it to the registry table",
                )
