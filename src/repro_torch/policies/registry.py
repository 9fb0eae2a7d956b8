"""Policy registry: the one seam between scheduling *policy* and serving
*mechanism* (a copy of ``repro.policies.registry``, prefill and decode
sides only).

The paper's claim is that the urgency-prefill / slack-decode policies are
separable from the serving substrate. Policies register themselves by name,
and the server constructs them through the factories, keyed by a
`PolicySpec`:

    spec  = PolicySpec("kairos-slack", {"slo_margin": 0.85})
    psch  = make_prefill("kairos-urgency")
    dsch  = make_decode(spec, lut)
    names = available_policies()   # {"prefill": (...), "decode": (...)}

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


@dataclass(frozen=True)
class PolicySpec:
    """Serializable policy reference: registered name + construction kwargs.

    A bare string is accepted anywhere a spec is (it coerces to
    ``PolicySpec(name)`` with no kwargs).
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


def available_prefill_policies() -> Tuple[str, ...]:
    return tuple(sorted(_PREFILL))


def available_decode_policies() -> Tuple[str, ...]:
    return tuple(sorted(_DECODE))


def available_policies() -> Dict[str, Tuple[str, ...]]:
    """Every registered policy name, per side."""
    return {
        "prefill": available_prefill_policies(),
        "decode": available_decode_policies(),
    }


def _lookup(table: Dict[str, _Entry], kind: str, name: str) -> _Entry:
    try:
        return table[name]
    except KeyError:
        known = ", ".join(sorted(table))
        raise ValueError(
            f"unknown {kind} policy {name!r}; registered {kind} policies: {known}"
        ) from None


def _build(
    table: Dict[str, _Entry],
    kind: str,
    spec: Union[str, PolicySpec],
    positional: Tuple[Any, ...],
    soft_defaults: Mapping[str, Any],
):
    spec = PolicySpec.coerce(spec)
    entry = _lookup(table, kind, spec.name)
    params = dict(inspect.signature(entry.cls).parameters)
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
