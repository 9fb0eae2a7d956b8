"""Policy registry: the one seam between scheduling *policy* and serving
*mechanism* (a copy of ``repro.policies.registry``).

The paper's claim is that the urgency-prefill / slack-decode policies are
separable from the serving substrate. Policies register themselves by name,
and the serving layers construct them through the factories, keyed by a
`PolicySpec`: the server its prefill and decode schedulers, the router its
placement policy, the disagg fleet its deflection rule, the fleet
controller its autoscaler.

    spec  = PolicySpec("kairos-slack", {"slo_margin": 0.85})
    psch  = make_prefill("kairos-urgency")
    dsch  = make_decode(spec, lut)
    names = available_policies()   # {"prefill": (...), "decode": (...), ...}

Registering a new policy is one decorator on the implementing class::

    @register_prefill("my-policy")
    @dataclass
    class MyPrefillScheduler:
        def select(self, queue, t_now, mu, budget): ...

A class may be registered under several names with different construction
defaults (e.g. ``kairos-slack-greedy`` is ``SlackDecodeScheduler`` with
``require_throughput_gain=False``). Explicit `PolicySpec.kwargs` are strict
— an argument the policy's constructor does not accept raises — while
backend-supplied *soft* defaults (e.g. the engine's config-level
``slo_margin``) are silently dropped for policies that do not take them.
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import (
    Any,
    Dict,
    List,
    Mapping,
    Protocol,
    Sequence,
    Tuple,
    Union,
    runtime_checkable,
)

from repro_torch.core.lut import StepTimeLUT
from repro_torch.core.request import Request

# A prefill selection: (request, n_tokens) pairs, sum(n_tokens) <= budget.
Selection = List[Tuple[Request, int]]
# A decode partition: (batch to execute now, delayed set idling this step).
Partition = Tuple[List[Request], List[Request]]


@runtime_checkable
class PrefillPolicy(Protocol):
    """Chunked-prefill scheduler: picks who prefills how much this step."""

    name: str

    def select(
        self, queue: Sequence[Request], t_now: float, mu: float, budget: int
    ) -> Selection: ...


@runtime_checkable
class DecodePolicy(Protocol):
    """Decode-batch scheduler: partitions the active set each step."""

    name: str

    def select(self, active: Sequence[Request], t_now: float) -> Partition: ...

    def observe(self, batch: Sequence[Request], actual: float) -> None: ...


@runtime_checkable
class RouterPolicy(Protocol):
    """Multi-server routing: picks which replica a request lands on.

    ``replicas`` is a sequence of replica views (`repro_torch.serving.router.
    ReplicaState`: in-flight count, pending prefill tokens, throughput
    estimate, prefix-match probe); the policy returns an index into it.
    Where a request lands decides whether within-replica urgency scheduling
    can save its TTFT at all, so this is the fleet-level half of the
    scheduling story.
    """

    name: str

    def select(self, replicas: Sequence[Any], request: Request,
               prompt: Sequence[int]) -> int: ...


@runtime_checkable
class DeflectionPolicy(Protocol):
    """Prefill-deflection decision: should this request's *prefill* run on a
    decode-pool server instead of the prefill pool?

    ``fleet`` is a disagg fleet view (`repro_torch.serving.disagg.DisaggSession`):
    per-worker backlogs, throughput estimates, and free decode slots. Return
    True to deflect — the request prefills on an underutilized decode server
    and skips the cross-server KV handoff entirely (Microsoft's load-aware
    prefill deflection, PAPERS.md).
    """

    name: str

    def decide(self, fleet: Any, request: Request,
               prompt: Sequence[int]) -> bool: ...


@runtime_checkable
class AutoscalerPolicy(Protocol):
    """Elastic-scaling decision: how many replicas should the fleet run?

    ``slo`` is `repro_torch.obs.slo.windowed_slo` output (per-window attainment,
    queue-depth gauges, decode-time-vs-TPOT-budget series) — deliberately
    *not* session internals, so the controller reacts to the same telemetry
    an operator would watch. Return the desired live-replica count; the
    fleet controller clamps it to ``[n_min, n_max]`` and performs at most
    one scale step per control interval.
    """

    name: str

    def decide(self, slo: Mapping[str, Any], n_replicas: int,
               n_min: int, n_max: int) -> int: ...


@dataclass(frozen=True)
class PolicySpec:
    """Serializable policy reference: registered name + construction kwargs.

    The same spec drives both backends; a bare string is accepted anywhere a
    spec is (it coerces to ``PolicySpec(name)`` with no kwargs).
    """

    name: str
    kwargs: Mapping[str, Any] = field(default_factory=dict)

    @classmethod
    def coerce(cls, spec: Union[str, "PolicySpec"]) -> "PolicySpec":
        if isinstance(spec, PolicySpec):
            return spec
        if isinstance(spec, str):
            return cls(name=spec)
        raise TypeError(f"policy spec must be str or PolicySpec, got {type(spec)!r}")


@dataclass(frozen=True)
class _Entry:
    cls: type
    defaults: Mapping[str, Any]


_PREFILL: Dict[str, _Entry] = {}
_DECODE: Dict[str, _Entry] = {}
_ROUTER: Dict[str, _Entry] = {}
_DEFLECTION: Dict[str, _Entry] = {}
_AUTOSCALER: Dict[str, _Entry] = {}


def register_prefill(name: str, **defaults):
    """Class decorator: register a prefill policy under ``name``."""

    def deco(cls):
        _PREFILL[name] = _Entry(cls, defaults)
        return cls

    return deco


def register_decode(name: str, **defaults):
    """Class decorator: register a decode policy under ``name``.

    Decode constructors take the shared ``StepTimeLUT`` as their first
    positional argument; ``defaults`` pre-bind keyword arguments (used for
    named variants of one class).
    """

    def deco(cls):
        _DECODE[name] = _Entry(cls, defaults)
        return cls

    return deco


def register_router(name: str, **defaults):
    """Class decorator: register a routing policy under ``name``."""

    def deco(cls):
        _ROUTER[name] = _Entry(cls, defaults)
        return cls

    return deco


def register_deflection(name: str, **defaults):
    """Class decorator: register a prefill-deflection policy under ``name``."""

    def deco(cls):
        _DEFLECTION[name] = _Entry(cls, defaults)
        return cls

    return deco


def register_autoscaler(name: str, **defaults):
    """Class decorator: register an autoscaler policy under ``name``."""

    def deco(cls):
        _AUTOSCALER[name] = _Entry(cls, defaults)
        return cls

    return deco


def available_prefill_policies() -> Tuple[str, ...]:
    return tuple(sorted(_PREFILL))


def available_decode_policies() -> Tuple[str, ...]:
    return tuple(sorted(_DECODE))


def available_router_policies() -> Tuple[str, ...]:
    return tuple(sorted(_ROUTER))


def available_deflection_policies() -> Tuple[str, ...]:
    return tuple(sorted(_DEFLECTION))


def available_autoscaler_policies() -> Tuple[str, ...]:
    return tuple(sorted(_AUTOSCALER))


def available_policies() -> Dict[str, Tuple[str, ...]]:
    """Every registered policy name, per side — the CLI help / parity-test
    enumeration entry point."""
    return {
        "prefill": available_prefill_policies(),
        "decode": available_decode_policies(),
        "router": available_router_policies(),
        "deflection": available_deflection_policies(),
        "autoscaler": available_autoscaler_policies(),
    }


def _lookup(table: Dict[str, _Entry], kind: str, name: str) -> _Entry:
    try:
        return table[name]
    except KeyError:
        known = ", ".join(sorted(table))
        raise ValueError(
            f"unknown {kind} policy {name!r}; registered {kind} policies: {known}"
        ) from None


def _accepted_params(cls: type) -> Dict[str, inspect.Parameter]:
    return dict(inspect.signature(cls).parameters)


def _build(
    table: Dict[str, _Entry],
    kind: str,
    spec: Union[str, PolicySpec],
    positional: Tuple[Any, ...],
    soft_defaults: Mapping[str, Any],
):
    spec = PolicySpec.coerce(spec)
    entry = _lookup(table, kind, spec.name)
    params = _accepted_params(entry.cls)
    bad = [k for k in spec.kwargs if k not in params]
    if bad:
        raise ValueError(
            f"{kind} policy {spec.name!r} ({entry.cls.__name__}) does not accept "
            f"kwargs {bad}; accepted: {sorted(params)}"
        )
    kw: Dict[str, Any] = {k: v for k, v in soft_defaults.items() if k in params}
    kw.update(entry.defaults)
    kw.update(spec.kwargs)
    obj = entry.cls(*positional, **kw)
    # Stamp the registered name so metrics/logs show the variant actually
    # requested (e.g. kairos-slack-greedy, not its implementing class default).
    if "name" not in kw and getattr(obj, "name", spec.name) != spec.name:
        obj.name = spec.name
    return obj


def make_prefill(
    spec: Union[str, PolicySpec], **soft_defaults: Any
) -> PrefillPolicy:
    """Construct a registered prefill policy from a spec (or bare name)."""
    return _build(_PREFILL, "prefill", spec, (), soft_defaults)


def make_decode(
    spec: Union[str, PolicySpec], lut: StepTimeLUT, **soft_defaults: Any
) -> DecodePolicy:
    """Construct a registered decode policy around the shared step-time LUT.

    ``soft_defaults`` lets a backend forward config-level knobs (e.g. the
    engine's ``slo_margin``) without knowing which policies take them.
    """
    return _build(_DECODE, "decode", spec, (lut,), soft_defaults)


def make_router(spec: Union[str, PolicySpec], **soft_defaults: Any) -> RouterPolicy:
    """Construct a registered routing policy from a spec (or bare name)."""
    return _build(_ROUTER, "router", spec, (), soft_defaults)


def make_deflection(
    spec: Union[str, PolicySpec], **soft_defaults: Any
) -> DeflectionPolicy:
    """Construct a registered prefill-deflection policy from a spec/name."""
    return _build(_DEFLECTION, "deflection", spec, (), soft_defaults)


def make_autoscaler(
    spec: Union[str, PolicySpec], **soft_defaults: Any
) -> AutoscalerPolicy:
    """Construct a registered autoscaler policy from a spec (or bare name)."""
    return _build(_AUTOSCALER, "autoscaler", spec, (), soft_defaults)
