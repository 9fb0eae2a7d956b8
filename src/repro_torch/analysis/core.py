"""Checker framework for the port's static-analysis suite (a copy of
``repro.analysis.core``).

The determinism contracts this repo sells — bit-identical ManualClock parity
between `ServeSession`, the async frontend, and a 1-replica router; replayable
`SlotAllocator` snapshots; a stable bench-gate JSON schema — all rest on
invariants that no unit test can see being violated *by omission* (a stray
`time.monotonic()` in a policy keeps every parity test green while silently
voiding what they prove). This package makes those invariants machine-checked:
each `Checker` walks the project's `ast` trees and reports `Finding`s; the CLI
(`python -m repro_torch.analysis`) exits non-zero on any unsuppressed finding and CI
gates on it.

Suppression: a finding is suppressed by an inline pragma on the finding line
or the line directly above it::

    t0 = time.perf_counter()  # repro: allow[RPA001] wall-time is the point here

The justification text after the bracket is MANDATORY — a bare pragma does not
suppress and instead raises RPA900, so every exception in the tree documents
itself. Multiple codes: ``allow[RPA001,RPA002]``.

Scoping lives in `repro_torch.analysis.scopes`: each checker declares the package
prefixes it patrols, so e.g. `launch/` CLIs may legitimately read wall time
while `repro_torch.policies` may not.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Protocol, Sequence, Set

# `# repro: allow[RPA001] why this is fine` — justification text required.
PRAGMA_RE = re.compile(
    r"#\s*repro:\s*allow\[(?P<codes>[A-Z]{3}\d{3}(?:\s*,\s*[A-Z]{3}\d{3})*)\]"
    r"[ \t]*[-—:]*[ \t]*(?P<why>.*)$"
)

# Framework-level codes (checkers own RPA001..RPA005).
SYNTAX_ERROR = "RPA000"  # file does not parse; reported, never fatal
BAD_PRAGMA = "RPA900"  # suppression pragma without a justification


@dataclass(frozen=True)
class Finding:
    """One invariant violation, anchored to a repo-relative location."""

    file: str  # posix path relative to the repo root
    line: int
    code: str
    message: str

    def as_dict(self) -> Dict[str, object]:
        return dict(file=self.file, line=self.line, code=self.code, message=self.message)

    def __str__(self) -> str:
        return f"{self.file}:{self.line}: {self.code} {self.message}"


@dataclass
class SourceFile:
    """A parsed project file plus its suppression-pragma map."""

    path: Path  # absolute
    rel: str  # posix, repo-root-relative — the identity findings carry
    text: str
    tree: Optional[ast.Module]  # None when the file does not parse
    error: Optional[SyntaxError] = None
    # line -> codes suppressed on that line (honored for line and line+1)
    pragmas: Dict[int, Set[str]] = field(default_factory=dict)
    # pragma lines whose justification text is empty (RPA900)
    bad_pragma_lines: List[int] = field(default_factory=list)

    @property
    def lines(self) -> List[str]:
        return self.text.splitlines()

    def allows(self, code: str, line: int) -> bool:
        """Is `code` suppressed at `line` (same-line or line-above pragma)?"""
        return any(code in self.pragmas.get(at, ()) for at in (line, line - 1))


def _parse_pragmas(sf: SourceFile) -> None:
    for i, raw in enumerate(sf.text.splitlines(), start=1):
        m = PRAGMA_RE.search(raw)
        if not m:
            continue
        codes = {c.strip() for c in m.group("codes").split(",")}
        if not m.group("why").strip():
            # an unjustified pragma suppresses nothing — and is itself a finding
            sf.bad_pragma_lines.append(i)
            continue
        sf.pragmas.setdefault(i, set()).update(codes)


def load_source_file(path: Path, root: Path) -> SourceFile:
    text = path.read_text(encoding="utf-8")
    rel = path.resolve().relative_to(root.resolve()).as_posix()
    tree: Optional[ast.Module] = None
    error: Optional[SyntaxError] = None
    try:
        tree = ast.parse(text, filename=rel)
    except SyntaxError as e:  # degrade gracefully: one finding, run continues
        error = e
    sf = SourceFile(path=path, rel=rel, text=text, tree=tree, error=error)
    _parse_pragmas(sf)
    return sf


def find_repo_root(start: Path) -> Path:
    """Walk up to the directory holding pyproject.toml (or .git); the repo
    root anchors `rel` paths, scope prefixes, and the tests/DESIGN.md
    cross-references."""
    cur = start.resolve()
    if cur.is_file():
        cur = cur.parent
    for cand in (cur, *cur.parents):
        if (cand / "pyproject.toml").exists() or (cand / ".git").exists():
            return cand
    return cur


@dataclass
class Project:
    """Everything a checker may look at: parsed python files under the scan
    roots, plus the repo root for non-python cross-references (DESIGN.md,
    tests/) that repo-wide checkers consult directly."""

    root: Path
    files: List[SourceFile]

    def iter_files(self, prefixes: Sequence[str] = (), exclude: Sequence[str] = ()) -> Iterator[SourceFile]:
        """Parsed files whose repo-relative path starts with any prefix
        (empty = all), minus exact-or-prefix excludes."""
        for sf in self.files:
            if prefixes and not any(sf.rel.startswith(p) for p in prefixes):
                continue
            if any(sf.rel == e or sf.rel.startswith(e.rstrip("/") + "/") for e in exclude):
                continue
            yield sf

    def get(self, rel: str) -> Optional[SourceFile]:
        for sf in self.files:
            if sf.rel == rel:
                return sf
        return None


def load_project(paths: Sequence[Path], root: Optional[Path] = None) -> Project:
    root = root or find_repo_root(Path(paths[0]) if paths else Path.cwd())
    seen: Set[Path] = set()
    files: List[SourceFile] = []
    for p in paths:
        p = Path(p)
        candidates = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for c in candidates:
            c = c.resolve()
            if c in seen:
                continue
            seen.add(c)
            files.append(load_source_file(c, root))
    return Project(root=root, files=files)


class Checker(Protocol):
    """One invariant. `run` yields raw findings; the runner applies pragmas."""

    code: str
    description: str

    def run(self, project: Project) -> Iterator[Finding]: ...


def framework_findings(project: Project) -> Iterator[Finding]:
    """Findings the framework itself owns: unparseable files (RPA000) and
    justification-less pragmas (RPA900)."""
    for sf in project.files:
        if sf.error is not None:
            line = sf.error.lineno or 1
            yield Finding(
                sf.rel, line, SYNTAX_ERROR,
                f"file does not parse: {sf.error.msg} (checkers skipped this file)",
            )
        for line in sf.bad_pragma_lines:
            yield Finding(
                sf.rel, line, BAD_PRAGMA,
                "suppression pragma has no justification text; "
                "write `# repro: allow[CODE] <why this exception is sound>`",
            )


def run_checkers(
    project: Project,
    checkers: Iterable[Checker],
    select: Optional[Sequence[str]] = None,
) -> List[Finding]:
    """Run the selected checkers plus the framework checks, apply suppression
    pragmas, and return findings sorted by (file, line, code)."""
    selected = None if select is None else set(select)
    raw: List[Finding] = []
    for chk in checkers:
        if selected is not None and chk.code not in selected:
            continue
        raw.extend(chk.run(project))
    if selected is None or {SYNTAX_ERROR, BAD_PRAGMA} & selected:
        raw.extend(
            f for f in framework_findings(project)
            if selected is None or f.code in selected
        )
    kept: List[Finding] = []
    for f in raw:
        sf = project.get(f.file)
        # RPA900 is not self-suppressible: a pragma cannot vouch for itself
        if sf is not None and f.code != BAD_PRAGMA and sf.allows(f.code, f.line):
            continue
        kept.append(f)
    kept.sort(key=lambda f: (f.file, f.line, f.code))
    return kept


# --------------------------------------------------------------------------
# Shared AST utilities


def import_aliases(tree: ast.Module) -> Dict[str, str]:
    """Map local names to their dotted import origin.

    `import numpy as np` -> {"np": "numpy"};
    `from time import monotonic as m` -> {"m": "time.monotonic"}.
    Only module-level and function-level imports are walked — enough to
    resolve the call sites the checkers care about.
    """
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def dotted(node: ast.AST) -> Optional[str]:
    """Render a Name/Attribute chain as "a.b.c" (None for anything else,
    e.g. a call result or subscript in the chain)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def resolve_call(node: ast.Call, aliases: Dict[str, str]) -> Optional[str]:
    """Fully-qualified dotted name of a call target, import-aliases applied:
    `np.random.default_rng(0)` -> "numpy.random.default_rng"."""
    name = dotted(node.func)
    if name is None:
        return None
    head, _, rest = name.partition(".")
    origin = aliases.get(head)
    if origin is None:
        return name
    return f"{origin}.{rest}" if rest else origin
