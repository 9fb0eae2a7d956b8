"""Routing policies: which replica does a request land on? (A copy
of ``repro.policies.router``.)

Kairos schedules *within* one prefill/decode pair; at fleet scale the prior
question is placement — a request routed to an overloaded replica has lost
its TTFT before urgency scheduling ever sees it (the load-aware prefill
deflection argument, PAPERS.md). These policies consume the per-replica
view the `RouterSession` maintains (`repro_torch.serving.router.ReplicaState`):

    in_flight               requests routed there and not yet terminal
    pending_prefill_tokens  prompt tokens routed there whose prefill hasn't
                            finished (the prefill backlog)
    mu                      the replica's online prefill-throughput estimate
    prefix_match(prompt)    longest prefix (tokens) the router has already
                            sent to that replica

All four are deterministic pure functions of that view (plus internal
counters), so routed runs replay bit-for-bit on a `ManualClock` — the
failover/determinism property the slot-allocator snapshot fix protects.

Registered in the shared `repro_torch.policies` registry (`@register_router`);
`make_router("slack-aware")` builds them anywhere a name is accepted.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

from repro_torch.core.request import Request
from repro_torch.policies.registry import register_router


def _least_loaded(replicas: Sequence[Any]) -> int:
    """Lowest in-flight count; index breaks ties so replay is stable."""
    return min(range(len(replicas)), key=lambda i: (replicas[i].in_flight, i))


@register_router("round-robin")
@dataclass
class RoundRobinRouter:
    """Load-blind rotation — the baseline every aware policy must beat."""

    name: str = "round-robin"
    _next: int = field(default=0, init=False, repr=False)

    def select(self, replicas: Sequence[Any], request: Request,
               prompt: Sequence[int]) -> int:
        i = self._next % len(replicas)
        self._next += 1
        return i


@register_router("least-queued")
@dataclass
class LeastQueuedRouter:
    """Join the shortest queue: fewest routed-and-not-yet-terminal requests."""

    name: str = "least-queued"

    def select(self, replicas: Sequence[Any], request: Request,
               prompt: Sequence[int]) -> int:
        return _least_loaded(replicas)


@register_router("slack-aware")
@dataclass
class SlackAwareRouter:
    """Route by predicted prefill completion: the replica whose prefill
    backlog plus this prompt clears soonest at its observed throughput
    (backlog_tokens + input_len) / mu — TTFT-slack preserved at placement
    time, in-flight count as the tiebreak."""

    name: str = "slack-aware"

    def select(self, replicas: Sequence[Any], request: Request,
               prompt: Sequence[int]) -> int:
        def eta(i: int) -> float:
            r = replicas[i]
            return (r.pending_prefill_tokens + request.input_len) / max(r.mu, 1e-9)

        return min(range(len(replicas)), key=lambda i: (eta(i), replicas[i].in_flight, i))


@register_router("prefix-affinity")
@dataclass
class PrefixAffinityRouter:
    """Route to the replica already holding the longest prefix of this
    prompt (KV reuse beats load when a match exists); prompts with no match
    anywhere fall back to least-queued so cold traffic still balances."""

    name: str = "prefix-affinity"
    min_match_tokens: int = 1  # matches shorter than this don't steer

    def select(self, replicas: Sequence[Any], request: Request,
               prompt: Sequence[int]) -> int:
        matches = [r.prefix_match(prompt) for r in replicas]
        best = max(matches)
        if best >= self.min_match_tokens:
            return min(
                (i for i, m in enumerate(matches) if m == best),
                key=lambda i: (replicas[i].in_flight, i),
            )
        return _least_loaded(replicas)
