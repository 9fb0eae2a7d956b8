"""RPA003 — async safety.

The asyncio stepper (`serving/frontend.py`) and the fleet router
(`serving/router.py`) share one event loop with every client coroutine. A
synchronous blocking call inside any of their ``async def`` bodies —
``time.sleep``, a `Clock.sleep` on a wall clock, a synchronous
`ServeSession.run`, file IO — stalls the whole loop: every stream, every
admission, every replica. Worse, on a ManualClock the same call often
*works* (virtual sleeps return instantly), so the bug only manifests in
production wall-clock runs that tests never exercise.

Flagged inside ``async def`` bodies (nested synchronous ``def``s are skipped;
they define code, they don't run it here):

  * ``time.sleep(...)`` — use ``asyncio.sleep``;
  * ``<...>.clock.sleep(...)`` / ``clock.sleep(...)`` — blocking on a wall
    clock; route through an awaitable idle helper and pragma the
    virtual-clock fast path if it is genuinely non-blocking;
  * ``<...>session.run(...)`` — the synchronous replay loop; drive the
    engine via ``session.step()`` from the stepper instead;
  * builtin ``open(...)`` — file IO on the event loop.
"""
from __future__ import annotations

from typing import Iterator, List

import ast

from repro_torch.analysis.core import Finding, Project, dotted, import_aliases, resolve_call
from repro_torch.analysis.scopes import ASYNC_SCOPE


def _async_body_calls(fn: ast.AsyncFunctionDef) -> Iterator[ast.Call]:
    """Call nodes executed in the coroutine itself: descend the body but not
    into nested synchronous function definitions."""
    stack: List[ast.AST] = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, ast.FunctionDef):
            continue  # defined here, runs elsewhere
        if isinstance(node, ast.Call):
            yield node
        stack.extend(ast.iter_child_nodes(node))


class AsyncSafetyChecker:
    code = "RPA003"
    description = (
        "no blocking calls (time.sleep, clock.sleep, session.run, open) "
        "inside async def bodies of the asyncio-facing serving modules"
    )

    def run(self, project: Project) -> Iterator[Finding]:
        for sf in project.iter_files(ASYNC_SCOPE.include, ASYNC_SCOPE.exclude):
            if sf.tree is None:
                continue
            aliases = import_aliases(sf.tree)
            for fn in ast.walk(sf.tree):
                if not isinstance(fn, ast.AsyncFunctionDef):
                    continue
                for call in _async_body_calls(fn):
                    msg = self._blocking(call, aliases)
                    if msg:
                        yield Finding(
                            sf.rel,
                            call.lineno,
                            self.code,
                            f"{msg} inside `async def {fn.name}` blocks the "
                            "event loop (every stream and replica stalls)",
                        )

    @staticmethod
    def _blocking(call: ast.Call, aliases) -> str:
        target = resolve_call(call, aliases)
        if target == "time.sleep":
            return "`time.sleep(...)`"
        if target == "open" and isinstance(call.func, ast.Name):
            return "synchronous file IO `open(...)`"
        chain = dotted(call.func)
        if chain is None:
            return ""
        parts = chain.split(".")
        if parts[-1] == "sleep" and "clock" in parts[:-1]:
            return f"blocking `{chain}(...)`"
        if parts[-1] == "run" and any("session" in p for p in parts[:-1]):
            return f"synchronous `{chain}(...)`"
        return ""
