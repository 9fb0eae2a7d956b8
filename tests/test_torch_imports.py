"""The port stands alone: importing every ``repro_torch`` module (and
``chip_smoke.py``) loads neither JAX nor the JAX package, entry points
refuse to fall back to the CPU silently, and nothing builds at import."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


_PROBE = r"""
import importlib, sys
mods = sys.argv[1:]
for m in mods:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "repro"
             or m.startswith("repro."))
print("BAD", bad)
built = [m for m in ("triton",) if m in sys.modules]
print("BUILT", built)
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serving.engine import DisaggServer, EngineConfig
import torch
if not torch.cuda.is_available():
    cfg = get_config("llama3-8b-smoke").replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    for call in (lambda: DisaggServer(model, params, EngineConfig()),
                 lambda: model.init(0),
                 lambda: model.init_cache(1, 8)):
        try:
            call()
        except RuntimeError as e:
            assert "cuda" in str(e), e
        else:
            raise SystemExit("an entry point ran on the CPU without being asked")
    print("RAISES ok")
"""


def test_port_imports_nothing_of_jax_and_needs_a_device():
    mods = list(_modules())
    assert len(mods) > 25 and "repro_torch.models.moe" in mods
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _PROBE, *mods], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout
    assert "BUILT []" in proc.stdout, proc.stdout
    if not torch.cuda.is_available():
        assert "RAISES ok" in proc.stdout, proc.stdout


@pytest.mark.parametrize("path", [*sorted(PKG.rglob("*.py")), ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_statement(path):
    """Every import statement, top-level or inside a function (the
    subprocess probe above cannot see the lazy ones)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            root = n.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), f"{path}:{node.lineno} imports {n}"


def test_chip_smoke_fails_without_a_card_or_outside_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                          text=True, cwd=ROOT, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(alone)], capture_output=True, text=True,
                          cwd=tmp_path, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
