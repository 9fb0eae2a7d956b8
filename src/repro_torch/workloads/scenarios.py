"""Workload scenarios: named, seeded generators of multi-tenant traces (a
copy of ``repro.workloads.scenarios``).

A `Scenario` bundles what the paper's evaluation varies implicitly — the
arrival process, the request-length distribution, the tenant mix, and the
SLO class of each tenant — behind one call: ``scenario.generate(seed) ->
List[Request]``. Scenarios register by name (mirroring `repro_torch.policies`):

    @register_scenario("my-scenario")
    def my_scenario(n_requests=1000, **kw) -> Scenario: ...

    make_scenario("bursty", n_requests=200).generate(seed=0)
    available_scenarios()  # every registered name

Built-ins:

    paper-longtail  the paper's trace (wraps `TraceConfig`/`generate_trace`
                    bit-for-bit, for backward compatibility)
    bursty          Markov-modulated on/off arrivals, paper lengths
    diurnal         sinusoidal arrival rate (compressed daily cycle)
    multi-tenant    3 tenants with distinct length distributions and
                    TTFT/TPOT SLO classes (premium / standard / batch)
    heavy-head      long_frac cranked up to stress HOL blocking
    prefix-heavy    shared-system-prompt tenants (prefix-cache-friendly:
                    each group's prompts start with one template)
    flash-crowd     steady Poisson base load + one dense synchronized burst
                    (the request-imbalance spike the fleet controller's
                    autoscaler and failover paths are measured against)
    replay          JSONL trace via `load_trace` (requires path=...)
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.request import Request, SLOSpec
# LengthDist lives beside generate_trace: one source of truth for the
# paper's length mixture, shared by TraceConfig and per-tenant scenarios.
from repro_torch.sim.trace import (
    LengthDist,
    TraceConfig,
    generate_trace,
    load_trace,
    rescale_qps,
)
from repro_torch.workloads.arrivals import (
    ArrivalProcess,
    MarkovModulatedArrivals,
    PoissonArrivals,
    SinusoidalArrivals,
)


# The default SLO tier table (name -> numeric targets); scenarios may
# override per-name. Tiers are plain `SLOSpec`s — the same type every
# Request carries — so there is exactly one SLO-target type in the repo.
DEFAULT_SLO_CLASSES: Dict[str, SLOSpec] = {
    "premium": SLOSpec(ttft=4.0, tpot=0.040),
    "standard": SLOSpec(ttft=8.0, tpot=0.050),
    "batch": SLOSpec(ttft=30.0, tpot=0.200),
}


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's share of the trace, lengths, and SLO tier."""

    name: str
    weight: float = 1.0
    lengths: LengthDist = field(default_factory=LengthDist)
    slo_class: str = "standard"
    # fraction of each prompt that is the tenant's shared template (system
    # prompt / few-shot header). 0 = fully unique prompts; > 0 stamps
    # Request.prefix_group/prefix_frac so the engine harness materializes
    # literally shared prefix tokens — what prefix-cache-aware admission
    # and prefix-affinity routing exploit.
    shared_prefix_frac: float = 0.0


@dataclass(frozen=True)
class Scenario:
    """A named multi-tenant workload: everything needed to draw a trace."""

    name: str
    n_requests: int = 1000
    arrivals: ArrivalProcess = field(default_factory=PoissonArrivals)
    tenants: Tuple[TenantSpec, ...] = (TenantSpec("default"),)
    slo_classes: Mapping[str, SLOSpec] = field(
        default_factory=lambda: dict(DEFAULT_SLO_CLASSES)
    )

    def __post_init__(self):
        if self.n_requests <= 0:
            raise ValueError(f"n_requests must be positive, got {self.n_requests}")
        if not self.tenants:
            raise ValueError("scenario needs at least one tenant")
        for t in self.tenants:
            if t.weight <= 0:
                raise ValueError(f"tenant {t.name!r} has non-positive weight {t.weight}")
            if not 0.0 <= t.shared_prefix_frac < 1.0:
                raise ValueError(
                    f"tenant {t.name!r} shared_prefix_frac must be in [0, 1), "
                    f"got {t.shared_prefix_frac}"
                )
            if t.slo_class not in self.slo_classes:
                known = ", ".join(sorted(self.slo_classes))
                raise ValueError(
                    f"tenant {t.name!r} references unknown SLO class "
                    f"{t.slo_class!r}; known: {known}"
                )

    def generate(self, seed: int = 0) -> List[Request]:
        rng = np.random.default_rng(seed)
        n = self.n_requests
        arrivals = self.arrivals.times(n, rng)

        w = np.array([t.weight for t in self.tenants], float)
        tenant_idx = rng.choice(len(self.tenants), size=n, p=w / w.sum())

        input_lens = np.empty(n, int)
        output_lens = np.empty(n, int)
        for ti, tenant in enumerate(self.tenants):
            mask = tenant_idx == ti
            if mask.any():
                ins, outs = tenant.lengths.sample(int(mask.sum()), rng)
                input_lens[mask] = ins
                output_lens[mask] = outs

        reqs = []
        for i in range(n):
            tenant = self.tenants[tenant_idx[i]]
            slo = self.slo_classes[tenant.slo_class]
            reqs.append(
                Request(
                    rid=i,
                    arrival=float(arrivals[i]),
                    input_len=int(input_lens[i]),
                    output_len=int(output_lens[i]),
                    slo=slo,
                    tenant=tenant.name,
                    slo_class=tenant.slo_class,
                    prefix_group=tenant.name if tenant.shared_prefix_frac > 0 else "",
                    prefix_frac=tenant.shared_prefix_frac,
                )
            )
        return reqs


@dataclass(frozen=True)
class TraceConfigScenario:
    """Backward-compat wrapper: generates exactly `generate_trace(cfg)`.

    Keeps the paper trace bit-for-bit identical to the pre-workloads code
    path (same rng stream ordering), so existing sweeps don't shift.
    """

    name: str
    cfg: TraceConfig

    @property
    def n_requests(self) -> int:
        return self.cfg.n_requests

    def generate(self, seed: int = 0) -> List[Request]:
        return generate_trace(replace(self.cfg, seed=seed))


@dataclass(frozen=True)
class ReplayScenario:
    """Replays a JSONL trace (see `sim.trace.load_trace` for the format)."""

    name: str
    path: str
    n_requests: Optional[int] = None  # truncate; None = whole file
    qps: Optional[float] = None  # rescale arrivals to this rate

    def generate(self, seed: int = 0) -> List[Request]:
        # seed is accepted for interface uniformity; a replay is already
        # deterministic (the trace file *is* the randomness).
        reqs = load_trace(self.path)
        if self.n_requests is not None:
            reqs = reqs[: self.n_requests]
        # rescale AFTER truncating so the requested rate holds for the
        # prefix actually replayed (a bursty file front would otherwise
        # make the effective rate arbitrary)
        if self.qps is not None:
            rescale_qps(reqs, self.qps)
        return reqs


@dataclass(frozen=True)
class FlashCrowdScenario:
    """A steady base load with one dense, synchronized burst riding on top.

    ``crowd_frac`` of the requests arrive as a "crowd": a burst starting at
    ``t_crowd`` with exponential inter-arrivals at ``crowd_qps`` — an order
    of magnitude above the base rate — of short interactive requests. The
    burst is the canonical request-imbalance spike (PAPER §1): a fixed fleet
    queues it (standing queue depth, TTFT misses), which is exactly the
    windowed-telemetry signature reactive autoscalers key on. Rids are
    assigned in arrival order across both components, so replay drives are
    stable.
    """

    name: str
    n_requests: int = 200
    qps_base: float = 2.0
    crowd_frac: float = 0.5
    t_crowd: float = 10.0
    crowd_qps: float = 40.0
    slo_classes: Mapping[str, SLOSpec] = field(
        default_factory=lambda: dict(DEFAULT_SLO_CLASSES)
    )

    def __post_init__(self):
        if self.n_requests <= 0:
            raise ValueError(f"n_requests must be positive, got {self.n_requests}")
        if not 0.0 < self.crowd_frac < 1.0:
            raise ValueError(
                f"crowd_frac must be in (0, 1), got {self.crowd_frac}"
            )
        if self.qps_base <= 0 or self.crowd_qps <= 0:
            raise ValueError("qps_base and crowd_qps must be positive")

    def generate(self, seed: int = 0) -> List[Request]:
        rng = np.random.default_rng(seed)
        n_crowd = max(1, int(round(self.n_requests * self.crowd_frac)))
        n_base = self.n_requests - n_crowd
        reqs: List[Request] = []
        base_t = PoissonArrivals(qps=self.qps_base).times(n_base, rng)
        base_in, base_out = LengthDist().sample(n_base, rng)
        for t, i, o in zip(base_t, base_in, base_out):
            reqs.append(
                Request(
                    rid=0, arrival=float(t), input_len=int(i), output_len=int(o),
                    slo=self.slo_classes["standard"],
                    tenant="steady", slo_class="standard",
                )
            )
        crowd_t = self.t_crowd + np.cumsum(
            rng.exponential(1.0 / self.crowd_qps, n_crowd)
        )
        crowd_in, crowd_out = _INTERACTIVE_LENGTHS.sample(n_crowd, rng)
        for t, i, o in zip(crowd_t, crowd_in, crowd_out):
            reqs.append(
                Request(
                    rid=0, arrival=float(t), input_len=int(i), output_len=int(o),
                    slo=self.slo_classes["premium"],
                    tenant="crowd", slo_class="premium",
                )
            )
        reqs.sort(key=lambda r: r.arrival)
        for rid, r in enumerate(reqs):
            r.rid = rid
        return reqs


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

_SCENARIOS: Dict[str, Callable[..., object]] = {}


def register_scenario(name: str):
    """Decorator: register a scenario factory (kwargs -> Scenario-like)."""

    def deco(fn):
        _SCENARIOS[name] = fn
        return fn

    return deco


def available_scenarios() -> Tuple[str, ...]:
    return tuple(sorted(_SCENARIOS))


def make_scenario(name: str, **kwargs):
    """Build a registered scenario; kwargs are forwarded to its factory
    (every built-in accepts ``n_requests``)."""
    try:
        factory = _SCENARIOS[name]
    except KeyError:
        known = ", ".join(sorted(_SCENARIOS))
        raise ValueError(
            f"unknown scenario {name!r}; registered scenarios: {known}"
        ) from None
    return factory(**kwargs)


def generate_scenario(name: str, seed: int = 0, **kwargs) -> List[Request]:
    """One-shot: `make_scenario(name, **kwargs).generate(seed)`."""
    return make_scenario(name, **kwargs).generate(seed)


# --------------------------------------------------------------------------
# built-ins
# --------------------------------------------------------------------------

# Shorter-bodied distribution for interactive tenants; long-tail-free.
_INTERACTIVE_LENGTHS = LengthDist(
    long_frac=0.0,
    short_median=600.0,
    short_sigma=0.6,
    max_input=8192,
    out_median_short=150.0,
    max_output=1000,
)

# Batch/analytics tenant: mostly long documents, long answers.
_BATCH_LENGTHS = LengthDist(
    long_frac=0.5,
    short_median=6000.0,
    long_median=40000.0,
    out_median_short=300.0,
    out_median_long=400.0,
)


@register_scenario("paper-longtail")
def paper_longtail(n_requests: int = 1000, qps: float = 3.0, **cfg_over):
    """The paper's production-like trace (Fig. 1a), via `TraceConfig`."""
    return TraceConfigScenario(
        name="paper-longtail",
        cfg=TraceConfig(n_requests=n_requests, qps=qps, **cfg_over),
    )


@register_scenario("bursty")
def bursty(
    n_requests: int = 1000,
    qps_on: float = 9.0,
    qps_off: float = 0.6,
    mean_on: float = 15.0,
    mean_off: float = 30.0,
):
    """Markov-modulated on/off arrivals over the paper length mix."""
    return Scenario(
        name="bursty",
        n_requests=n_requests,
        arrivals=MarkovModulatedArrivals(
            qps_on=qps_on, qps_off=qps_off, mean_on=mean_on, mean_off=mean_off
        ),
    )


@register_scenario("diurnal")
def diurnal(
    n_requests: int = 1000,
    qps_mean: float = 3.0,
    amplitude: float = 0.8,
    period: float = 240.0,
):
    """Sinusoidal arrival rate — a compressed daily cycle."""
    return Scenario(
        name="diurnal",
        n_requests=n_requests,
        arrivals=SinusoidalArrivals(qps_mean=qps_mean, amplitude=amplitude, period=period),
    )


@register_scenario("multi-tenant")
def multi_tenant(n_requests: int = 1000, qps: float = 3.0):
    """Three tenants with distinct length distributions and SLO tiers:

    interactive  50%  short prompts, tight premium SLOs
    standard     30%  the paper mix, standard SLOs
    batch        20%  long documents, loose batch SLOs
    """
    return Scenario(
        name="multi-tenant",
        n_requests=n_requests,
        arrivals=PoissonArrivals(qps=qps),
        tenants=(
            TenantSpec("interactive", weight=0.5, lengths=_INTERACTIVE_LENGTHS,
                       slo_class="premium"),
            TenantSpec("standard", weight=0.3, lengths=LengthDist(),
                       slo_class="standard"),
            TenantSpec("batch", weight=0.2, lengths=_BATCH_LENGTHS,
                       slo_class="batch"),
        ),
    )


@register_scenario("heavy-head")
def heavy_head(n_requests: int = 1000, qps: float = 3.0, long_frac: float = 0.35):
    """Long requests dominate (high long_frac): maximal HOL-blocking stress."""
    return Scenario(
        name="heavy-head",
        n_requests=n_requests,
        arrivals=PoissonArrivals(qps=qps),
        tenants=(TenantSpec("default", lengths=LengthDist(long_frac=long_frac)),),
    )


@register_scenario("prefix-heavy")
def prefix_heavy(
    n_requests: int = 1000,
    qps: float = 4.0,
    n_groups: int = 4,
    prefix_frac: float = 0.7,
):
    """Shared-system-prompt tenants: ``n_groups`` apps, each stamping every
    request with one template covering ``prefix_frac`` of the prompt (RAG /
    agent / few-shot traffic). The ROADMAP's prefix-cache-friendly workload:
    per-replica hit rate — and therefore TTFT under load — depends on
    whether routing keeps a group's requests together (prefix-affinity) or
    scatters them (round-robin)."""
    tenants = tuple(
        TenantSpec(
            f"app-{g}",
            lengths=_INTERACTIVE_LENGTHS,
            slo_class=("premium", "standard")[g % 2],
            shared_prefix_frac=prefix_frac,
        )
        for g in range(n_groups)
    )
    return Scenario(
        name="prefix-heavy",
        n_requests=n_requests,
        arrivals=PoissonArrivals(qps=qps),
        tenants=tenants,
    )


@register_scenario("flash-crowd")
def flash_crowd(
    n_requests: int = 200,
    qps_base: float = 2.0,
    crowd_frac: float = 0.5,
    t_crowd: float = 10.0,
    crowd_qps: float = 40.0,
):
    """Steady base + one dense burst: the churn backend's native workload."""
    return FlashCrowdScenario(
        name="flash-crowd",
        n_requests=n_requests,
        qps_base=qps_base,
        crowd_frac=crowd_frac,
        t_crowd=t_crowd,
        crowd_qps=crowd_qps,
    )


@register_scenario("replay")
def replay(path: Optional[str] = None, n_requests: Optional[int] = None,
           qps: Optional[float] = None):
    """Replay a JSONL trace: `make_scenario("replay", path="trace.jsonl")`."""
    if path is None:
        raise ValueError(
            'the "replay" scenario requires a trace file: '
            'make_scenario("replay", path="trace.jsonl") '
            "(see sim.trace.load_trace for the JSONL format)"
        )
    return ReplayScenario(name="replay", path=path, n_requests=n_requests, qps=qps)
