"""Prefill-deflection policies: should a prompt prefill on the decode pool? (A copy
of ``repro.policies.deflection``.)

In a disaggregated fleet the prefill pool is the TTFT bottleneck under
bursty prompt-heavy load while decode servers idle between steps. Load-aware
prefill deflection (Microsoft, PAPERS.md) diverts *short* prompts to
underutilized decode servers when the prefill pool is under pressure: a
short prompt barely perturbs a decode server's step time, and a deflected
request skips the cross-server KV handoff entirely (its KV is already where
decode happens).

Policies consume the fleet view `repro_torch.serving.disagg.DisaggSession`:

    fleet.prefill_pool / fleet.decode_pool   worker views, each exposing
        queue_len                queued-or-prefilling requests on the worker
        pending_prefill_tokens   prompt tokens not yet prefilled there
        mu                       the server's prefill-throughput estimate
        free_slots               free decode slots (decode workers)
    fleet.decode_has_capacity()  any decode worker has a free slot and a
                                 below-watermark deflected backlog

`decide(fleet, request, prompt) -> bool` is a deterministic pure function of
that view, so disagg runs replay bit-for-bit on a `ManualClock` — the same
property the router policies protect.

Registered under the fourth registry side (`@register_deflection`);
`make_deflection("prefill-pressure")` builds them anywhere a name works.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

from repro_torch.core.request import Request
from repro_torch.policies.registry import register_deflection


def _pool_prefill_backlog(fleet: Any) -> int:
    """Pool-total token backlog: the pressure signal. The *sum* (not the
    per-worker minimum) is what predicts TTFT risk — with join-shortest
    placement one idle worker keeps the minimum pinned at zero right through
    a burst, while the pool total rises with every queued prompt."""
    return sum(w.pending_prefill_tokens for w in fleet.prefill_pool)


@register_deflection("never")
@dataclass
class NeverDeflect:
    """All prefills stay on the prefill pool — the pure-disaggregation
    baseline every aware policy must beat (and the 1P:1D parity anchor)."""

    name: str = "never"

    def decide(self, fleet: Any, request: Request,
               prompt: Sequence[int]) -> bool:
        return False


@register_deflection("short-prompt-threshold")
@dataclass
class ShortPromptDeflect:
    """Deflect every prompt at or under ``short_tokens`` whenever the decode
    pool has capacity, regardless of prefill-pool load. Load-blind: the
    baseline that shows *unconditional* deflection steals decode step time
    even when the prefill pool was idle anyway."""

    name: str = "short-prompt-threshold"
    short_tokens: int = 8

    def decide(self, fleet: Any, request: Request,
               prompt: Sequence[int]) -> bool:
        return request.input_len <= self.short_tokens and fleet.decode_has_capacity()


@register_deflection("prefill-pressure")
@dataclass
class PrefillPressureDeflect:
    """The paper's load-aware rule: deflect short prompts only while the
    prefill pool is *pressured* — the pool-total pending-token backlog is at
    or above ``watermark_tokens`` — and some decode worker has capacity.
    The default watermark is calibrated to the miniature engine twin
    (prompts of 2-24 tokens, 100x-compressed arrivals), where any standing
    backlog at all marks a burst the pool is not absorbing."""

    name: str = "prefill-pressure"
    short_tokens: int = 8
    watermark_tokens: int = 2

    def decide(self, fleet: Any, request: Request,
               prompt: Sequence[int]) -> bool:
        if request.input_len > self.short_tokens:
            return False
        if _pool_prefill_backlog(fleet) < self.watermark_tokens:
            return False
        return fleet.decode_has_capacity()


@register_deflection("slack-aware")
@dataclass
class SlackAwareDeflect:
    """Deflect when the prefill pool cannot clear this prompt inside its
    TTFT budget but the decode pool can: compare the best prefill worker's
    predicted completion (backlog + input_len) / mu against ``margin`` x the
    request's TTFT SLO, and require the best decode worker to beat it."""

    name: str = "slack-aware"
    margin: float = 0.8

    def decide(self, fleet: Any, request: Request,
               prompt: Sequence[int]) -> bool:
        def eta(w: Any) -> float:
            return (w.pending_prefill_tokens + request.input_len) / max(w.mu, 1e-9)

        eta_p = min(eta(w) for w in fleet.prefill_pool)
        if eta_p <= request.slo.ttft * self.margin:
            return False  # prefill pool still makes the deadline
        if not fleet.decode_has_capacity():
            return False
        eta_d = min(eta(w) for w in fleet.decode_pool)
        return eta_d < eta_p
