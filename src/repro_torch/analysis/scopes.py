"""Per-checker scoping: which packages of the port each invariant patrols.
The reference's scopes, with every prefix on ``src/repro_torch/``.

The whitelist is as load-bearing as the ban. `launch/` CLIs (dryrun, train,
elastic, loadgen, evaluate) legitimately read host wall time — compile-time
reporting and operator progress lines are *about* wall time — so RPA001
deliberately excludes them (in the port as in the reference, every
`time.time`/`perf_counter` there feeds a human-facing progress print, a
`wall_time_s`-style report field or a host time the profiler reports, never
a scheduling decision). Likewise `serving/clock.py` is the one
place wall clocks are *supposed* to live: it is the injection boundary.

`repro_torch.models`, `repro_torch.kernels`, `repro_torch.training` draw
from generators made from a seed (`Model.init(seed)` through a
`torch.Generator`, the synthetic dataset through a seeded numpy
`Generator`) and are outside RPA002's decision-path scope; the ban is
on *hidden global state* feeding scheduling decisions. Inside the scope
RPA002 also bans torch's global generator (a draw without ``generator=``,
or seeding it), the one source of such state the port has beyond numpy's
and the stdlib's.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class Scope:
    include: Tuple[str, ...]  # repo-relative path prefixes
    exclude: Tuple[str, ...] = field(default_factory=tuple)


# RPA001 clock hygiene: all timing in the deterministic core must flow
# through the injectable Clock (serving/clock.py), or ManualClock parity
# between sim / session / async frontend / router silently breaks.
CLOCK_SCOPE = Scope(
    include=(
        "src/repro_torch/sim/",
        "src/repro_torch/serving/",
        "src/repro_torch/policies/",
        "src/repro_torch/workloads/",
        "src/repro_torch/core/",
        # observability must obey the same discipline: TraceRecorder never
        # reads a clock — every timestamp is handed in by an emitting
        # session that already read it from its injected Clock
        "src/repro_torch/obs/",
    ),
    exclude=("src/repro_torch/serving/clock.py",),  # the injection boundary itself
)

# RPA002 RNG discipline: decision paths may only draw randomness from an
# explicitly-seeded Generator that the caller threads through.
RNG_SCOPE = Scope(
    include=(
        "src/repro_torch/sim/",
        "src/repro_torch/serving/",
        "src/repro_torch/policies/",
        "src/repro_torch/workloads/",
        "src/repro_torch/core/",
        "src/repro_torch/obs/",
    ),
)

# RPA003 async safety: only the asyncio-facing modules; everything else is
# deliberately synchronous.
ASYNC_SCOPE = Scope(
    include=(
        "src/repro_torch/serving/frontend.py",
        "src/repro_torch/serving/router.py",
        "src/repro_torch/serving/fleetctl.py",
    ),
)

# RPA004 registry coverage / RPA005 metrics schema: repo-wide over src.
SRC_SCOPE = Scope(include=("src/repro_torch/",))
