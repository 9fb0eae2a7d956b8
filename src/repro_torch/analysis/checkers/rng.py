"""RPA002 — RNG discipline.

Scenario generation, the simulator, and engine sampling are deterministic
functions of (config, seed): every random draw in a decision path must come
from an explicitly-seeded `np.random.Generator` or `torch.Generator` that the
caller threads through. Three patterns break that and are banned here, as in
the reference's checker:

  * ``np.random.default_rng()`` with no seed argument — seeds from OS entropy,
    so two runs of the "same" scenario diverge;
  * module-level ``np.random.<fn>(...)`` — draws from numpy's hidden global
    state, which any import can perturb;
  * stdlib ``random.*`` — global state again, plus Python's per-process hash
    salt leaks into common idioms around it.

The port has one more source of hidden global state, torch's default
generator (the reference's decision paths can reach none: ``jax.random`` is
functional), so two more patterns are banned under the same code:

  * a torch draw without ``generator=`` — ``torch.rand``/``randn``/
    ``multinomial``/… (``_TORCH_DRAWS``), any ``torch.nn.init.*``, or a
    tensor's in-place or method draw (``x.uniform_()``, ``p.multinomial(1)``,
    ``_TENSOR_DRAWS``);
  * seeding torch's global generator (``torch.manual_seed`` and its kin,
    ``_GLOBAL_SEEDING``): a decision path that needs it is drawing from it.
"""
from __future__ import annotations

from typing import Iterator

import ast

from repro_torch.analysis.core import Finding, Project, import_aliases, resolve_call
from repro_torch.analysis.scopes import RNG_SCOPE

# numpy.random attributes that are constructors/types, not global-state draws
_NUMPY_OK = {
    "default_rng",
    "Generator",
    "SeedSequence",
    "BitGenerator",
    "PCG64",
    "Philox",
}

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


def _torch_rule(node: ast.Call, target: str) -> str:
    """The message for a draw from, or a seeding of, torch's global
    generator at `node` ("" for anything else)."""
    if target in _GLOBAL_SEEDING:
        return (f"`{target}()` seeds torch's global generator; decision paths "
                "must thread a seeded torch.Generator instead")
    method = node.func.attr if isinstance(node.func, ast.Attribute) else ""
    draws = (target in _TORCH_DRAWS or target.startswith("torch.nn.init.")
             or (method in _TENSOR_DRAWS and not target.startswith("numpy.")))
    if draws and not any(k.arg == "generator" for k in node.keywords):
        return (f"`{target or method}()` without `generator=` draws from torch's "
                "global generator; pass a torch.Generator made from the seed")
    return ""


class RngDisciplineChecker:
    code = "RPA002"
    description = (
        "decision-path randomness must be an explicitly-seeded Generator: "
        "no seedless default_rng(), no np.random global state, no stdlib random, "
        "no torch draw without generator= and no torch global seeding"
    )

    def run(self, project: Project) -> Iterator[Finding]:
        for sf in project.iter_files(RNG_SCOPE.include, RNG_SCOPE.exclude):
            if sf.tree is None:
                continue
            aliases = import_aliases(sf.tree)
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Call):
                    continue
                # "" where the target is no dotted name: only a method draw
                # (on a call result or a subscript) can match then
                target = resolve_call(node, aliases) or ""
                torch_msg = _torch_rule(node, target)
                if target == "numpy.random.default_rng":
                    if not node.args and not node.keywords:
                        yield Finding(
                            sf.rel,
                            node.lineno,
                            self.code,
                            "`default_rng()` without a seed draws from OS "
                            "entropy; pass an explicit seed expression",
                        )
                elif target.startswith("numpy.random."):
                    attr = target.split(".", 2)[2]
                    if attr not in _NUMPY_OK and "." not in attr:
                        yield Finding(
                            sf.rel,
                            node.lineno,
                            self.code,
                            f"module-level `np.random.{attr}()` uses numpy's "
                            "hidden global RNG state; thread a seeded "
                            "Generator through instead",
                        )
                elif target.startswith("random."):
                    yield Finding(
                        sf.rel,
                        node.lineno,
                        self.code,
                        f"stdlib `{target}()` uses process-global RNG state; "
                        "decision paths must use a seeded np.random.Generator",
                    )
                elif torch_msg:
                    yield Finding(sf.rel, node.lineno, self.code, torch_msg)
