"""Mutation-style fixture tests for the port's checker suite,
``repro_torch.analysis``: torch twins of tests/test_analysis_checkers.py on
fixture trees under ``src/repro_torch/``, then the port held against the
reference. Every fixture with no torch draw is mirrored under ``src/repro/``
and both packages' ``analyze`` must give the same findings (code, line, file
with the package prefix mapped); torch draws on a decision path are the one
place only the port flags, and a name that only a reference test mentions
is the one place only the port's RPA004 reports."""
from __future__ import annotations

import json
import textwrap
from pathlib import Path
from typing import Optional

import pytest

pytest.importorskip("torch")

from repro.analysis import analyze as jax_analyze  # noqa: E402
from repro.analysis import load_project as jax_load_project  # noqa: E402
from repro.analysis import run_checkers as jax_run_checkers  # noqa: E402
from repro.analysis.checkers import MetricsSchemaChecker as JaxMetricsSchemaChecker  # noqa: E402
from repro.analysis.checkers.schema import extract_schema as jax_extract_schema  # noqa: E402
from repro_torch.analysis import analyze, load_project, run_checkers  # noqa: E402
from repro_torch.analysis.checkers import (  # noqa: E402
    ALL_CHECKERS,
    AsyncSafetyChecker,
    ClockHygieneChecker,
    MetricsSchemaChecker,
    RegistryCoverageChecker,
    RngDisciplineChecker,
)
from repro_torch.analysis.checkers.schema import extract_schema  # noqa: E402
from repro_torch.analysis.core import load_source_file  # noqa: E402

PORT, REF = "src/repro_torch/", "src/repro/"


def make_repo(tmp_path: Path, files: dict, design: str = "", tests: Optional[dict] = None) -> Path:
    """Materialize a fixture mini-repo (pyproject marker anchors the root)."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    (tmp_path / "pyproject.toml").write_text("[project]\nname='fixture'\n")
    (tmp_path / "DESIGN.md").write_text(design)
    for rel, text in {**files, **{f"tests/{k}": v for k, v in (tests or {}).items()}}.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    return tmp_path


def run_on(tmp_path: Path, files: dict, select=None, **kw):
    root = make_repo(tmp_path, files, **kw)
    return analyze([str(root / "src")], select=select, root=root)


_POLICY = """\
from repro_torch.policies.registry import register_prefill, register_decode


@register_prefill("zzz-pol")
class P:
    pass


register_decode("yyy-dec", flag=True)(P)
"""

# Fixture trees, each a twin of a reference test's tree moved under
# src/repro_torch/ (test files named test_torch_*.py so that both packages'
# RPA004 count them). `run_fixture` builds one for a twin test; the parity
# test builds each twice, once per package.
FIXTURES = {
    "wall_clock": dict(files={
        "src/repro_torch/sim/bad.py": """\
        import time


        def now():
            return time.time()
        """}),
    "import_alias": dict(files={
        "src/repro_torch/policies/bad.py": """\
        from time import perf_counter as pc


        def cost():
            return pc()
        """}),
    "launch_and_clock_py": dict(files={
        # launch CLIs legitimately read wall time: out of scope
        "src/repro_torch/launch/cli.py": "import time\nt = time.time()\n",
        # the injection boundary itself is excluded
        "src/repro_torch/serving/clock.py": "import time\nt = time.monotonic()\n",
    }),
    "justified_pragma": dict(files={
        "src/repro_torch/sim/ok.py": """\
        import time

        t0 = time.perf_counter()  # repro: allow[RPA001] host wall time on purpose
        """}),
    "unjustified_pragma": dict(files={
        "src/repro_torch/sim/sneaky.py": """\
        import time

        t0 = time.perf_counter()  # repro: allow[RPA001]
        """}),
    "pragma_line_above": dict(files={
        "src/repro_torch/sim/ok.py": """\
        import time

        # repro: allow[RPA001] wall time measured deliberately here
        t0 = time.perf_counter()
        """}),
    "clean_file": dict(files={
        "src/repro_torch/sim/clean.py": """\
        def f(clock):
            return clock.monotonic()
        """}),
    "seedless_default_rng": dict(files={
        "src/repro_torch/workloads/bad.py": """\
        import numpy as np

        rng = np.random.default_rng()
        ok = np.random.default_rng(42)
        """}),
    "global_numpy_and_stdlib_random": dict(files={
        "src/repro_torch/sim/bad.py": """\
        import random

        import numpy as np

        x = np.random.shuffle([1, 2])
        y = random.randint(0, 3)
        """}),
    "threaded_generator": dict(files={
        "src/repro_torch/sim/ok.py": """\
        import numpy as np


        def sample(rng: np.random.Generator):
            return rng.integers(0, 10, 4)
        """}),
    "async_blocking": dict(files={
        "src/repro_torch/serving/frontend.py": """\
        import asyncio
        import time


        async def stepper(self):
            time.sleep(0.1)
            self.server.clock.sleep(0.1)
            self.session.run([])
            with open("x") as fh:
                pass
            await asyncio.sleep(0)  # fine
        """}),
    "async_sync_defs_and_other_files": dict(files={
        # nested sync def: defined in the coroutine, runs elsewhere
        "src/repro_torch/serving/router.py": """\
        import time


        async def outer():
            def helper():
                time.sleep(1)
            return helper
        """,
        # same blocking call in a module RPA003 does not patrol
        "src/repro_torch/serving/engine.py": """\
        import time


        async def f():
            time.sleep(1)
        """,
    }),
    "registry_tested_and_documented": dict(
        files={"src/repro_torch/policies/p.py": _POLICY},
        design="| `zzz-pol` | x |\n| `yyy-dec` | y |\n",
        tests={"test_torch_p.py": "NAMES = ['zzz-pol', 'yyy-dec']\n"}),
    "registry_untested_and_undocumented": dict(
        files={"src/repro_torch/policies/p.py": _POLICY},
        design="only `zzz-pol` documented\n",
        tests={"test_torch_p.py": "run('zzz-pol')\n"}),
    "registry_substring": dict(
        files={"src/repro_torch/policies/p.py": """\
        from repro_torch.policies.registry import register_decode


        @register_decode("kai-slack")
        class D:
            pass
        """},
        # mentions only the -greedy variant; must NOT cover "kai-slack"
        design="`kai-slack-greedy` is documented\n",
        tests={"test_torch_d.py": "make('kai-slack-greedy')\n"}),
    "syntax_error": dict(files={
        "src/repro_torch/sim/broken.py": "def f(:\n    pass\n",
        "src/repro_torch/sim/bad.py": "import time\nt = time.time()\n",
    }),
    "clock_and_random": dict(files={
        "src/repro_torch/sim/bad.py":
            "import time\nimport random\nt = time.time()\nr = random.random()\n",
    }),
    "pragma_wrong_code": dict(files={
        # an RPA002 pragma must not silence an RPA001 finding on the same line
        "src/repro_torch/sim/bad.py": """\
        import time

        t0 = time.time()  # repro: allow[RPA002] wrong code entirely
        """}),
    # ---- the port's own cases: no parity with the reference by design
    "torch_draws": dict(files={
        "src/repro_torch/serving/draws.py": (
            "import torch\n"
            "from torch import randn\n"
            "a = torch.multinomial(p, 1)\n"                      # 3: global generator
            "b = torch.multinomial(p, 1, generator=g)\n"         # fine
            "c = randn(3)\n"                                     # 5: aliased, global
            "w.uniform_()\n"                                     # 6: in-place draw
            "w.normal_(generator=g)\n"                           # fine
            "torch.manual_seed(0)\n"                             # 8: global seeding
            "torch.nn.init.xavier_uniform_(w)\n"                 # 9: global generator
            "q = torch.argmax(p)\n"                              # fine
        )}),
    "registry_reference_test_only": dict(
        files={"src/repro_torch/policies/p.py": _POLICY},
        design="| `zzz-pol` | x |\n| `yyy-dec` | y |\n",
        # yyy-dec is named by a reference test only, which exercises repro's
        # policy of that name and not the port's
        tests={"test_torch_p.py": "NAMES = ['zzz-pol']\n", "test_x.py": "NAMES = ['yyy-dec']\n"}),
}
PORT_ONLY = ("torch_draws", "registry_reference_test_only")


def run_fixture(tmp_path: Path, name: str, select=None):
    return run_on(tmp_path, dict(FIXTURES[name]["files"]), select=select,
                  **{k: v for k, v in FIXTURES[name].items() if k != "files"})


# ---------------------------------------------------------------- RPA001


def test_rpa001_catches_wall_clock_read_at_line(tmp_path):
    findings = run_fixture(tmp_path, "wall_clock", select=["RPA001"])
    assert [(f.code, f.file, f.line) for f in findings] == [
        ("RPA001", "src/repro_torch/sim/bad.py", 5)
    ]
    assert "Clock" in findings[0].message
    assert "repro_torch.serving.clock" in findings[0].message


def test_rpa001_sees_through_import_aliases(tmp_path):
    findings = run_fixture(tmp_path, "import_alias", select=["RPA001"])
    assert len(findings) == 1 and findings[0].line == 5


def test_rpa001_whitelists_launch_and_clock_py(tmp_path):
    assert run_fixture(tmp_path, "launch_and_clock_py", select=["RPA001"]) == []


def test_rpa001_justified_pragma_suppresses(tmp_path):
    assert run_fixture(tmp_path, "justified_pragma", select=["RPA001", "RPA900"]) == []


def test_unjustified_pragma_does_not_suppress_and_is_flagged(tmp_path):
    findings = run_fixture(tmp_path, "unjustified_pragma", select=["RPA001", "RPA900"])
    assert sorted(f.code for f in findings) == ["RPA001", "RPA900"]


def test_pragma_on_line_above_suppresses(tmp_path):
    assert run_fixture(tmp_path, "pragma_line_above", select=["RPA001", "RPA900"]) == []


def test_clean_file_yields_zero_findings(tmp_path):
    findings = run_fixture(tmp_path, "clean_file",
                           select=["RPA001", "RPA002", "RPA003", "RPA004", "RPA900"])
    assert findings == []


# ---------------------------------------------------------------- RPA002


def test_rpa002_seedless_default_rng(tmp_path):
    findings = run_fixture(tmp_path, "seedless_default_rng", select=["RPA002"])
    assert [(f.code, f.line) for f in findings] == [("RPA002", 3)]
    assert "seed" in findings[0].message


def test_rpa002_global_numpy_and_stdlib_random(tmp_path):
    findings = run_fixture(tmp_path, "global_numpy_and_stdlib_random", select=["RPA002"])
    assert [(f.code, f.line) for f in findings] == [("RPA002", 5), ("RPA002", 6)]


def test_rpa002_threaded_generator_is_fine(tmp_path):
    assert run_fixture(tmp_path, "threaded_generator", select=["RPA002"]) == []


# ---------------------------------------------------------------- RPA003


def test_rpa003_blocking_calls_in_async_def(tmp_path):
    findings = run_fixture(tmp_path, "async_blocking", select=["RPA003"])
    assert [f.line for f in findings] == [6, 7, 8, 9]
    assert all(f.code == "RPA003" for f in findings)


def test_rpa003_ignores_sync_defs_and_other_files(tmp_path):
    assert run_fixture(tmp_path, "async_sync_defs_and_other_files", select=["RPA003"]) == []


# ---------------------------------------------------------------- RPA004


def test_rpa004_clean_when_tested_and_documented(tmp_path):
    assert run_fixture(tmp_path, "registry_tested_and_documented", select=["RPA004"]) == []


def test_rpa004_flags_untested_and_undocumented_at_registration_line(tmp_path):
    findings = run_fixture(tmp_path, "registry_untested_and_undocumented", select=["RPA004"])
    # yyy-dec (direct factory-call form, line 9): untested AND undocumented
    assert [f.line for f in findings] == [9, 9]
    assert any("tests/" in f.message for f in findings)
    assert any("DESIGN.md" in f.message for f in findings)


def test_rpa004_substring_match_does_not_count(tmp_path):
    findings = run_fixture(tmp_path, "registry_substring", select=["RPA004"])
    assert len(findings) == 2  # untested + undocumented


# ---------------------------------------------------------------- RPA005


_SESSION = """\
class ServeSession:
    def summary(self):
        agg = dict(alpha=1, beta=2)
        out = dict(gamma=3, **agg)
        out["delta"] = 4
        out.update(epsilon=5)
        return out
"""


def _schema_checker(rel_schema: str, cls=MetricsSchemaChecker, pkg: str = PORT):
    chk = cls()
    chk.schema_rel = rel_schema
    chk.specs = (
        ("s.summary", f"{pkg}serving/session.py", ("ServeSession", "summary"), "keys"),
    )
    return chk


def test_rpa005_fingerprint_covers_dict_update_subscript_and_star_kwargs(tmp_path):
    root = make_repo(tmp_path, {"src/repro_torch/serving/session.py": _SESSION})
    project = load_project([root / "src"], root=root)
    chk = _schema_checker("schema.json")
    schema = extract_schema(project, chk.specs)
    assert schema["entries"]["s.summary"] == ["alpha", "beta", "delta", "epsilon", "gamma"]


def test_rpa005_drift_is_flagged_both_directions(tmp_path):
    root = make_repo(tmp_path, {"src/repro_torch/serving/session.py": _SESSION})
    chk = _schema_checker("schema.json")
    committed = dict(
        version=1,
        entries={"s.summary": ["alpha", "beta", "delta", "gamma", "vanished"]},
    )
    (root / "schema.json").write_text(json.dumps(committed))
    project = load_project([root / "src"], root=root)
    findings = run_checkers(project, [chk], select=["RPA005"])
    msgs = [f.message for f in findings]
    assert len(findings) == 2
    assert any("'epsilon'" in m and "not in the committed schema" in m for m in msgs)
    assert any("'vanished'" in m and "no longer emits" in m for m in msgs)
    assert all(f.line == 2 for f in findings)  # anchored at the summary() def


def test_rpa005_missing_schema_file_is_one_finding(tmp_path):
    root = make_repo(tmp_path, {"src/repro_torch/serving/session.py": _SESSION})
    project = load_project([root / "src"], root=root)
    findings = run_checkers(project, [_schema_checker("nope.json")], select=["RPA005"])
    assert len(findings) == 1 and "--write-schema" in findings[0].message


def test_rpa005_matching_schema_is_clean(tmp_path):
    root = make_repo(tmp_path, {"src/repro_torch/serving/session.py": _SESSION})
    chk = _schema_checker("schema.json")
    project = load_project([root / "src"], root=root)
    (root / "schema.json").write_text(json.dumps(extract_schema(project, chk.specs)))
    assert run_checkers(project, [chk], select=["RPA005"]) == []


# ------------------------------------------------------- framework behavior


def test_syntax_error_degrades_to_rpa000_and_run_continues(tmp_path):
    findings = run_fixture(tmp_path, "syntax_error", select=["RPA000", "RPA001"])
    codes = {f.code for f in findings}
    assert "RPA000" in codes  # broken file reported with its location...
    assert "RPA001" in codes  # ...and the healthy file was still checked
    rpa000 = next(f for f in findings if f.code == "RPA000")
    assert rpa000.file == "src/repro_torch/sim/broken.py" and rpa000.line == 1


def test_select_filters_checkers(tmp_path):
    only_clock = run_fixture(tmp_path, "clock_and_random", select=["RPA001"])
    assert {f.code for f in only_clock} == {"RPA001"}
    both = run_fixture(tmp_path, "clock_and_random", select=["RPA001", "RPA002"])
    assert {f.code for f in both} == {"RPA001", "RPA002"}


def test_pragma_requires_exact_code(tmp_path):
    findings = run_fixture(tmp_path, "pragma_wrong_code", select=["RPA001"])
    assert [f.code for f in findings] == ["RPA001"]


def test_all_checkers_have_unique_codes_and_descriptions():
    codes = [cls.code for cls in ALL_CHECKERS]
    assert len(codes) == len(set(codes)) == 5
    assert all(cls.description for cls in ALL_CHECKERS)
    assert {ClockHygieneChecker, RngDisciplineChecker, AsyncSafetyChecker,
            RegistryCoverageChecker, MetricsSchemaChecker} == set(ALL_CHECKERS)


def test_load_source_file_parses_pragma_lists(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("a = 1  # repro: allow[RPA001,RPA002] two codes, one reason\n")
    sf = load_source_file(p, tmp_path)
    assert sf.allows("RPA001", 1) and sf.allows("RPA002", 1)
    assert sf.allows("RPA001", 2)  # next line covered too
    assert not sf.allows("RPA003", 1)


# ------------------------------------------------- the port against repro


def _mirror(fixture: dict) -> dict:
    """The fixture's tree under src/repro/, imports mapped too."""
    files = {rel.replace(PORT, REF, 1): text.replace("repro_torch.", "repro.")
             for rel, text in fixture["files"].items()}
    return {**fixture, "files": files}


def _located(findings, from_ref: bool = False):
    return [(f.code, f.line, f.file.replace(REF, PORT, 1) if from_ref else f.file)
            for f in findings]


@pytest.mark.parametrize("name", [n for n in FIXTURES if n not in PORT_ONLY])
def test_both_packages_give_the_same_findings(name, tmp_path):
    """Every code (RPA000-005, RPA900) over each fixture and its mirror."""
    port_root = make_repo(tmp_path / "port", **FIXTURES[name])
    ref_root = make_repo(tmp_path / "ref", **_mirror(FIXTURES[name]))
    got = analyze([str(port_root / "src")], root=port_root)
    want = jax_analyze([str(ref_root / "src")], root=ref_root)
    assert _located(got) == _located(want, from_ref=True)
    # the committed schema is missing in every fixture tree: RPA005 says so
    assert ("RPA005", 1, "src/repro_torch/analysis/schema/metrics_schema.json") in _located(got)


@pytest.mark.parametrize("committed", ["drifted", "missing", "matching"])
def test_both_packages_give_the_same_schema_findings(committed, tmp_path):
    trees = {}
    for pkg, cls, extract, load in ((PORT, MetricsSchemaChecker, extract_schema, load_project),
                                    (REF, JaxMetricsSchemaChecker, jax_extract_schema,
                                     jax_load_project)):
        root = make_repo(tmp_path / pkg.strip("/").replace("/", "_"),
                         {f"{pkg}serving/session.py": _SESSION})
        chk = _schema_checker("schema.json", cls, pkg)
        project = load([root / "src"], root=root)
        entries = extract(project, chk.specs)
        if committed == "drifted":
            entries = dict(version=1, entries={"s.summary": ["alpha", "gamma", "vanished"]})
        if committed != "missing":
            (root / "schema.json").write_text(json.dumps(entries))
        run = run_checkers if pkg == PORT else jax_run_checkers
        trees[pkg] = (extract(project, chk.specs), run(project, [chk], select=["RPA005"]))
    assert trees[PORT][0] == trees[REF][0]
    assert _located(trees[PORT][1]) == _located(trees[REF][1], from_ref=True)
    assert len(trees[PORT][1]) == {"drifted": 4, "missing": 1, "matching": 0}[committed]


def test_the_ports_rng_rule_flags_torch_draws_the_reference_cannot_see(tmp_path):
    """The one place only the port flags: torch's global generator on a
    decision path (the reference's decision paths use jax.random keys)."""
    findings = run_fixture(tmp_path / "port", "torch_draws", select=["RPA002"])
    assert [(f.code, f.line) for f in findings] == [
        ("RPA002", 3), ("RPA002", 5), ("RPA002", 6), ("RPA002", 8), ("RPA002", 9)]
    assert "global generator" in findings[0].message
    assert "seeds torch's global generator" in findings[3].message
    ref_root = make_repo(tmp_path / "ref", **_mirror(FIXTURES["torch_draws"]))
    assert jax_analyze([str(ref_root / "src")], root=ref_root, select=["RPA002"]) == []


def test_torch_draws_outside_the_decision_path_or_under_a_pragma_pass(tmp_path):
    text = FIXTURES["torch_draws"]["files"]["src/repro_torch/serving/draws.py"]
    justified = text.replace("w.uniform_()\n",
                             "w.uniform_()  # repro: allow[RPA002] init, not a decision\n")
    findings = run_on(tmp_path, {
        # models/ and kernels/ lie outside RPA002's scope
        "src/repro_torch/models/init.py": text,
        "src/repro_torch/kernels/x/ref.py": text,
        "src/repro_torch/policies/seeded.py": justified,
    }, select=["RPA002", "RPA900"])
    assert [(f.file, f.line) for f in findings] == [
        ("src/repro_torch/policies/seeded.py", n) for n in (3, 5, 8, 9)]


def test_rpa004_counts_only_the_ports_tests(tmp_path):
    """A name only tests/test_x.py mentions is untested for the port, while
    the reference's RPA004 counts every test file."""
    findings = run_fixture(tmp_path / "port", "registry_reference_test_only", select=["RPA004"])
    assert [(f.code, f.line) for f in findings] == [("RPA004", 9)]
    assert "yyy-dec" in findings[0].message and "test_torch_*.py" in findings[0].message
    ref_root = make_repo(tmp_path / "ref", **_mirror(FIXTURES["registry_reference_test_only"]))
    assert jax_analyze([str(ref_root / "src")], root=ref_root, select=["RPA004"]) == []
