"""Injectable clocks for the serving engine.

`DisaggServer` historically called ``time.monotonic()`` directly, which made
every engine test wall-clock-dependent (and flaky under CI load). The engine
now reads time through a ``Clock`` object:

    MonotonicClock  production default — thin wrapper over time.monotonic
    ManualClock     tests — time advances only when the test (or the
                    engine's own idle-sleep) says so, making TTFT/TPOT
                    arithmetic exactly reproducible run-to-run

``ManualClock.auto_step`` optionally advances time by a fixed amount per
``monotonic()`` read, modeling "each observation costs dt" so elapsed-time
deltas (LUT observations, prefill-throughput updates) are non-zero yet
deterministic.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Protocol, runtime_checkable


@runtime_checkable
class Clock(Protocol):
    def monotonic(self) -> float: ...

    def sleep(self, dt: float) -> None: ...

    def peek(self) -> float: ...


@dataclass
class MonotonicClock:
    """Wall clock (production default)."""

    def monotonic(self) -> float:
        return time.monotonic()

    def sleep(self, dt: float) -> None:
        if dt > 0:
            time.sleep(dt)

    def peek(self) -> float:
        """Same reading as ``monotonic`` — the wall clock has no observer
        cost, so observing and peeking are one operation."""
        return time.monotonic()


@dataclass
class ManualClock:
    """Deterministic virtual clock for tests.

    ``sleep`` advances virtual time instead of blocking, so engine idle
    waits (e.g. for a future arrival) complete instantly and identically
    on every run.
    """

    t: float = 0.0
    auto_step: float = 0.0  # seconds added per monotonic() read

    def __post_init__(self) -> None:
        # the construction origin — what reset() must restore, NOT a
        # literal 0.0: a clock built at t=5 that "re-zeroes" to 0 would
        # break construction parity for restarted replicas
        self._t_init = self.t

    def monotonic(self) -> float:
        self.t += self.auto_step
        return self.t

    def sleep(self, dt: float) -> None:
        if dt > 0:
            self.t += dt

    def advance(self, dt: float) -> None:
        self.t += dt

    def peek(self) -> float:
        """Current virtual time WITHOUT charging ``auto_step`` — the
        control plane's read. A fleet controller polling via ``monotonic``
        would advance every replica's time by how often it looked,
        destroying replay determinism; ``peek`` is observation-free."""
        return self.t

    def reset(self) -> float:
        """Restore virtual time to its construction value and return it.
        Sessions call this (via `DisaggServer.reset_clock`) so runs
        accumulate ``auto_step`` from exactly the origin — float
        accumulation depends on the starting value, so without the reset
        two runs whose *construction* paths read the clock a different
        number of times would disagree in the last ulp even with identical
        serving-time read sequences. Restarted replicas
        (`DisaggServer.reset_for_restart`) rely on the construction-value
        contract for post-failover timing parity."""
        self.t = self._t_init
        return self.t
