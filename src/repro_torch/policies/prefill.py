"""Prefill-side policies: Kairos urgency (paper Algorithm 1) + baselines.

A prefill policy's job each step: given the queue and a chunk budget ``C``
(chunked prefill, Sarathi-style), pick which requests contribute how many
tokens to this step. Output is a list of (request, n_tokens) with
sum(n_tokens) <= C; a request whose remaining tokens exceed the leftover
budget gets a partial chunk (paper Alg. 1 lines 16-18).

Every class here registers itself in the policy registry; both the
simulator and the engine construct them via ``make_prefill`` — see
``repro_torch.policies.registry``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.predictor import predict_all_finish_times
from repro_torch.core.request import Request
from repro_torch.policies.registry import Selection, register_prefill


def _pack_budget(ordered: Sequence[Request], budget: int) -> Selection:
    """Greedy chunk packing in the given priority order."""
    out: Selection = []
    used = 0
    for r in ordered:
        if used >= budget:
            break
        take = min(r.remaining_prefill_tokens, budget - used)
        if take <= 0:
            continue
        out.append((r, take))
        used += take
    return out


@register_prefill("kairos-urgency")
@dataclass
class UrgencyPrefillScheduler:
    """Paper Algorithm 1: urgency-based priority scheduling.

    score = ((SLO_TTFT - (finish_fcfs - arrive)) / SLO_TTFT) / input_len
    sorted descending; chunk budget filled greedily with partial tail chunk.
    """

    name: str = "kairos-urgency"

    def select(
        self, queue: Sequence[Request], t_now: float, mu: float, budget: int
    ) -> Selection:
        if not queue:
            return []
        finish = predict_all_finish_times(queue, t_now, mu)
        scores = np.empty(len(queue))
        for i, r in enumerate(queue):
            slack = r.slo.ttft - (finish[i] - r.arrival)
            scores[i] = (slack / r.slo.ttft) / max(1, r.input_len)
        # descending by score; rid tiebreak for determinism
        order = np.lexsort((np.array([r.rid for r in queue]), -scores))
        return _pack_budget([queue[i] for i in order], budget)

    def urgency_scores(
        self, queue: Sequence[Request], t_now: float, mu: float
    ) -> np.ndarray:
        finish = predict_all_finish_times(queue, t_now, mu)
        return np.array(
            [
                ((r.slo.ttft - (finish[i] - r.arrival)) / r.slo.ttft) / max(1, r.input_len)
                for i, r in enumerate(queue)
            ]
        )


@register_prefill("kairos-urgency-plus")
@dataclass
class UrgencyPlusPrefillScheduler:
    """Beyond-paper fix of Algorithm 1's negative-slack ordering inversion.

    As printed, u = (slack/SLO)/len sorted descending: once slack < 0 the
    1/len normalization *inverts* — among late requests the LONGEST ranks
    first (its negative score is closest to zero), so a 128K request that
    drove everyone's predicted slack negative monopolizes the budget and
    Kairos degenerates to worse-than-FCFS exactly in the HOL scenario the
    paper targets (observed in sim at util >~0.7).

    Fix: triage into three tiers by *optimistic* slack (if scheduled now:
    finish = t_now + remaining/mu):
      1. rescuable  — FCFS-slack < 0 but optimistic slack >= 0: most urgent;
         ordered by ascending paper-score (shortest/most-behind first).
      2. comfortable — FCFS-slack >= 0: paper's descending order (verbatim).
      3. lost — optimistic slack < 0: cannot meet the SLO even if scheduled
         immediately; ordered by descending score (paper tie-break), they
         only consume leftover budget.
    """

    name: str = "kairos-urgency-plus"

    def select(
        self, queue: Sequence[Request], t_now: float, mu: float, budget: int
    ) -> Selection:
        if not queue:
            return []
        finish = predict_all_finish_times(queue, t_now, mu)
        mu = max(mu, 1e-9)
        tiers: List[Tuple[int, float, int, Request]] = []
        for i, r in enumerate(queue):
            slack_fcfs = r.slo.ttft - (finish[i] - r.arrival)
            slack_opt = r.slo.ttft - (
                (t_now + r.remaining_prefill_tokens / mu) - r.arrival
            )
            u = (slack_fcfs / r.slo.ttft) / max(1, r.input_len)
            if slack_opt < 0:
                tiers.append((2, -u, r.rid, r))  # lost: desc u
            elif slack_fcfs < 0:
                tiers.append((0, u, r.rid, r))  # rescuable: asc u
            else:
                tiers.append((1, -u, r.rid, r))  # comfortable: desc u
        tiers.sort(key=lambda t: (t[0], t[1], t[2]))
        return _pack_budget([t[3] for t in tiers], budget)


@register_prefill("fcfs")
@dataclass
class FCFSPrefillScheduler:
    """DistServe baseline: arrival order + chunked prefill."""

    name: str = "fcfs"

    def select(
        self, queue: Sequence[Request], t_now: float, mu: float, budget: int
    ) -> Selection:
        ordered = sorted(queue, key=lambda r: (r.arrival, r.rid))
        return _pack_budget(ordered, budget)


@register_prefill("sjf")
@dataclass
class SJFPrefillScheduler:
    """Shortest-job-first (paper discusses as impractical: starves long)."""

    name: str = "sjf"

    def select(
        self, queue: Sequence[Request], t_now: float, mu: float, budget: int
    ) -> Selection:
        ordered = sorted(queue, key=lambda r: (r.remaining_prefill_tokens, r.rid))
        return _pack_budget(ordered, budget)


@register_prefill("edf")
@dataclass
class EDFPrefillScheduler:
    """Earliest-deadline-first ablation (deadline = arrival + SLO_TTFT)."""

    name: str = "edf"

    def select(
        self, queue: Sequence[Request], t_now: float, mu: float, budget: int
    ) -> Selection:
        ordered = sorted(queue, key=lambda r: (r.arrival + r.slo.ttft, r.rid))
        return _pack_budget(ordered, budget)


@register_prefill("srpt")
@dataclass
class SRPTPrefillScheduler:
    """Shortest-remaining-processing-time: the theory-grounded reference.

    "Optimal Scheduling Algorithms for LLM Inference" (PAPERS.md) proves
    SRPT-style index rules are optimal (fluid limit) for mean latency in
    single-server LLM serving. Unlike ``sjf`` — which ranks by remaining
    *prefill* only — SRPT's index is the request's whole remaining service:
    prefill tokens still to compute plus decode tokens still to emit, so a
    short prompt with a long generation queues behind a long prompt that is
    nearly done. Reported next to kairos, it turns "beats fcfs" into "how
    far from the clairvoyant-optimal ordering".
    """

    name: str = "srpt"

    def select(
        self, queue: Sequence[Request], t_now: float, mu: float, budget: int
    ) -> Selection:
        ordered = sorted(
            queue,
            key=lambda r: (
                r.remaining_prefill_tokens + max(0, r.output_len - r.n_generated),
                r.rid,
            ),
        )
        return _pack_budget(ordered, budget)


@register_prefill("cache-aware")
@dataclass
class CacheAwarePrefillScheduler:
    """Prefix-reuse-aware urgency: weigh cached pages against TTFT slack.

    On a paged engine (DESIGN.md §kvcache) a request whose prompt head is
    already in the radix cache costs only its *uncached* tail of prefill
    compute, so between two requests with equal slack the one with more
    cached tokens finishes its prefill sooner per budget token. The score is
    kairos-urgency's slack ratio normalized by the request's **remaining**
    (uncached) prefill work rather than its full prompt length:

        score = ((SLO_TTFT - (finish_fcfs - arrive)) / SLO_TTFT)
                / max(1, remaining_prefill_tokens)

    With no prefix cache (``prefix_cached_tokens == 0`` everywhere and no
    chunks run) the ordering matches kairos-urgency exactly; with reuse it
    drains high-hit requests first — which also re-touches their shared
    pages, keeping hot prefixes at the LRU head (sglang's cache-aware
    scheduling argument, SNIPPETS.md §3).
    """

    name: str = "cache-aware"

    def select(
        self, queue: Sequence[Request], t_now: float, mu: float, budget: int
    ) -> Selection:
        if not queue:
            return []
        finish = predict_all_finish_times(queue, t_now, mu)
        scores = np.empty(len(queue))
        for i, r in enumerate(queue):
            slack = r.slo.ttft - (finish[i] - r.arrival)
            scores[i] = (slack / r.slo.ttft) / max(1, r.remaining_prefill_tokens)
        order = np.lexsort((np.array([r.rid for r in queue]), -scores))
        return _pack_budget([queue[i] for i in order], budget)
