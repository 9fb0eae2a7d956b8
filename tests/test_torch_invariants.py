"""The repository's static invariants over the port. The ``repro.analysis``
checkers patrol paths under ``src/repro/`` only (``scopes.py``); here the
clock (RPA001), RNG (RPA002) and async-safety (RPA003) scopes are moved onto
the same paths under ``src/repro_torch/`` for the length of a test, and the
port's decision-path code must come out clean. One rule is the test's own,
because RPA002 knows numpy's and the stdlib's generators only: no torch
random draw on a decision path without ``generator=``, and no seeding of
torch's global generator there."""
import ast
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.analysis import analyze  # noqa: E402
from repro.analysis.checkers import asyncsafe, clock, rng  # noqa: E402
from repro.analysis.core import import_aliases, load_project, resolve_call  # noqa: E402
from repro.analysis.scopes import Scope  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CODES = ["RPA000", "RPA001", "RPA002", "RPA003", "RPA900"]

# torch functions that draw from a generator: the global one unless given
_TORCH_DRAWS = {
    "torch." + f for f in ("rand", "randn", "randint", "randperm", "multinomial", "normal",
                           "bernoulli", "poisson", "rand_like", "randn_like", "randint_like")
}
# in-place and method draws on a tensor (``x.uniform_()``, ``p.multinomial(1)``)
_TENSOR_DRAWS = {"uniform_", "normal_", "random_", "exponential_", "geometric_", "cauchy_",
                 "log_normal_", "bernoulli_", "bernoulli", "multinomial"}
_GLOBAL_SEEDING = {"torch.manual_seed", "torch.seed", "torch.random.manual_seed",
                   "torch.random.seed", "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
                   "torch.cuda.seed", "torch.cuda.seed_all"}


def _port(scope: Scope) -> Scope:
    move = lambda paths: tuple(p.replace("src/repro/", "src/repro_torch/", 1) for p in paths)
    return Scope(include=move(scope.include), exclude=move(scope.exclude))


@pytest.fixture
def port_scopes(monkeypatch):
    """The checkers read their scope from their own module's globals."""
    scopes = {}
    for mod, name in ((clock, "CLOCK_SCOPE"), (rng, "RNG_SCOPE"), (asyncsafe, "ASYNC_SCOPE")):
        scopes[name] = _port(getattr(mod, name))
        monkeypatch.setattr(mod, name, scopes[name])
    return scopes


def test_scopes_cover_the_ports_decision_path(port_scopes):
    project = load_project([ROOT / "src" / "repro_torch"], root=ROOT)
    for name, scope in port_scopes.items():
        files = [sf.rel for sf in project.iter_files(scope.include, scope.exclude)]
        assert files and all(f.startswith("src/repro_torch/") for f in files), name
    covered = {sf.rel for sf in project.iter_files(port_scopes["CLOCK_SCOPE"].include)}
    for rel in ("src/repro_torch/sim/simulator.py", "src/repro_torch/workloads/harness.py",
                "src/repro_torch/workloads/scenarios.py", "src/repro_torch/core/pacer.py",
                "src/repro_torch/serving/fleetctl.py", "src/repro_torch/obs/slo.py"):
        assert rel in covered, rel


def test_port_passes_the_clock_rng_and_async_checkers(port_scopes):
    findings = analyze([str(ROOT / "src" / "repro_torch")], root=ROOT, select=CODES)
    assert findings == [], "findings on the port:\n" + "\n".join(map(str, findings))


def test_the_moved_scopes_catch_a_violation(port_scopes, tmp_path):
    """Negative control: the same checkers, moved, flag a wall-clock read
    and a global-RNG draw in a port decision-path file."""
    (tmp_path / "pyproject.toml").write_text("[project]\nname='fixture'\n")
    bad = tmp_path / "src" / "repro_torch" / "workloads" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import time\nimport numpy as np\nt = time.monotonic()\nx = np.random.rand()\n")
    findings = analyze([str(tmp_path / "src")], root=tmp_path, select=CODES)
    assert [(f.code, f.line) for f in findings] == [("RPA001", 3), ("RPA002", 4)]


def _torch_draw_findings(path: Path, rel: str):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    aliases = import_aliases(tree)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        target = resolve_call(node, aliases) or ""
        has_gen = any(k.arg == "generator" for k in node.keywords)
        method = node.func.attr if isinstance(node.func, ast.Attribute) else ""
        if target in _GLOBAL_SEEDING:
            yield f"{rel}:{node.lineno} seeds torch's global generator ({target})"
        elif (target in _TORCH_DRAWS or target.startswith("torch.nn.init.")
              or (method in _TENSOR_DRAWS and not target.startswith("numpy."))) and not has_gen:
            yield f"{rel}:{node.lineno} draws ({target or method}) without generator="


def _decision_path_files():
    scope = _port(rng.RNG_SCOPE)
    project = load_project([ROOT / "src" / "repro_torch"], root=ROOT)
    return [(sf.path, sf.rel) for sf in project.iter_files(scope.include, scope.exclude)]


def test_no_torch_draw_without_a_generator_on_a_decision_path():
    files = _decision_path_files()
    assert any(rel.endswith("serving/sampler.py") for _, rel in files)
    found = [f for path, rel in files for f in _torch_draw_findings(path, rel)]
    assert found == [], "\n".join(found)


def test_the_torch_draw_rule_catches_its_cases(tmp_path):
    src = tmp_path / "draws.py"
    src.write_text(
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
    )
    lines = [int(f.split(":")[1].split()[0]) for f in _torch_draw_findings(src, "draws.py")]
    assert lines == [3, 5, 6, 8, 9]


def _negative_control(tmp_path: Path) -> Path:
    (tmp_path / "pyproject.toml").write_text("[project]\nname='fixture'\n")
    bad = tmp_path / "src" / "repro_torch" / "workloads" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import time\nimport numpy as np\nt = time.monotonic()\nx = np.random.rand()\n")
    return tmp_path


@pytest.mark.parametrize("tree", ["committed", "negative_control"])
def test_the_ports_own_checkers_equal_the_moved_ones(port_scopes, tmp_path, tree):
    """``repro_torch.analysis`` gives the findings of the reference's
    checkers moved onto the port, on the committed tree and on the negative
    control above; its RPA002 flags the lines the torch-draw rule here flags."""
    from repro_torch.analysis import analyze as port_analyze

    root = ROOT if tree == "committed" else _negative_control(tmp_path)
    src = root / "src" / ("repro_torch" if tree == "committed" else "")
    moved = analyze([str(src)], root=root, select=CODES)
    own = port_analyze([str(src)], root=root, select=CODES)
    assert [(f.code, f.file, f.line) for f in own] == [(f.code, f.file, f.line) for f in moved]
    assert len(own) == (0 if tree == "committed" else 2)

    draws = tmp_path / "src" / "repro_torch" / "policies" / "draws.py"
    draws.parent.mkdir(parents=True, exist_ok=True)
    draws.write_text("import torch\na = torch.rand(2)\nb = torch.rand(2, generator=g)\n"
                     "w.bernoulli_()\ntorch.cuda.manual_seed_all(1)\nv = p.multinomial(1)\n")
    rule = [int(f.split(":")[1].split()[0])
            for f in _torch_draw_findings(draws, "src/repro_torch/policies/draws.py")]
    port = [f.line for f in port_analyze([str(draws)], root=tmp_path, select=["RPA002"])]
    assert rule == port == [2, 4, 5, 6]
