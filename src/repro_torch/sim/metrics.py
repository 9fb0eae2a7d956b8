"""SLO-attainment and throughput metrics (paper §4.1 Metrics; a copy of
``repro.sim.metrics``).

Attainment semantics: a request shed by admission control (``Phase.FAILED``)
is an SLO *miss*, not a non-event — by default it counts in the denominator
of every attainment fraction (and contributes nothing to the numerator).
``attainment(done_only=True)`` restores the historical completed-only view
for callers that explicitly want conditional attainment.

Client-cancelled requests (``Phase.CANCELLED``) are a third, distinct kind
of terminal request: the *client* withdrew (disconnect, backpressure shed of
a slow consumer), so the server neither met nor missed an SLO for them.
They are excluded from every attainment fraction's numerator AND
denominator, and surfaced separately as ``n_cancelled`` — conflating them
with ``FAILED`` (as a pre-cancellation-aware caller might) would punish a
policy for clients that walked away.

Multi-tenant additions: ``attainment_by`` groups the same metrics per tenant
or per SLO class, and ``goodput`` reports SLO-met generated tokens per
second — the paper-style "useful throughput" a sweep should maximize.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np

from repro_torch.core.request import Phase, Request
from repro_torch.sim.simulator import SimResult


@dataclass(frozen=True)
class Attainment:
    ttft: float  # fraction of requests meeting the TTFT SLO
    tpot: float  # fraction meeting the TPOT SLO (mean inter-token latency)
    e2e: float  # both
    decode_tput_p50: float  # median per-request decode tokens/sec
    decode_tput_mean: float
    n: int  # requests in the denominator (completed + shed unless done_only)
    n_shed: int = 0  # Phase.FAILED requests counted as misses
    n_cancelled: int = 0  # Phase.CANCELLED: client withdrew; not in n

    def as_dict(self) -> Dict[str, float]:
        return dict(
            ttft=self.ttft,
            tpot=self.tpot,
            e2e=self.e2e,
            decode_tput_p50=self.decode_tput_p50,
            decode_tput_mean=self.decode_tput_mean,
            n=self.n,
            n_shed=self.n_shed,
            n_cancelled=self.n_cancelled,
        )


def attainment(requests: Sequence[Request], done_only: bool = False) -> Attainment:
    """SLO attainment over the terminal requests (DONE, plus FAILED unless
    ``done_only``). Shed requests met no SLO: they dilute every fraction.
    Cancelled requests are the client's doing — reported via ``n_cancelled``
    but never in the fractions (see module docstring)."""
    done = [r for r in requests if r.phase == Phase.DONE]
    shed = [] if done_only else [r for r in requests if r.phase == Phase.FAILED]
    n_cancelled = sum(r.phase == Phase.CANCELLED for r in requests)
    n = len(done) + len(shed)
    if n == 0:
        return Attainment(0.0, 0.0, 0.0, 0.0, 0.0, 0, n_cancelled=n_cancelled)
    ttft = sum(r.meets_ttft() for r in done) / n
    tpot = sum(r.meets_tpot() for r in done) / n
    e2e = sum(r.meets_e2e() for r in done) / n
    tputs = [t for t in (r.decode_tput() for r in done) if t is not None]
    p50 = float(np.percentile(tputs, 50)) if tputs else 0.0
    mean = float(np.mean(tputs)) if tputs else 0.0
    return Attainment(ttft, tpot, e2e, p50, mean, n, n_shed=len(shed), n_cancelled=n_cancelled)


def attainment_by(
    requests: Sequence[Request],
    key: Union[str, Callable[[Request], str]] = "tenant",
    done_only: bool = False,
) -> Dict[str, Attainment]:
    """Attainment broken down by a request attribute (``"tenant"``,
    ``"slo_class"``) or an arbitrary key function."""
    keyfn = (lambda r: getattr(r, key)) if isinstance(key, str) else key
    groups: Dict[str, List[Request]] = {}
    for r in requests:
        groups.setdefault(keyfn(r), []).append(r)
    return {k: attainment(groups[k], done_only=done_only) for k in sorted(groups)}


def attainment_by_pool(
    requests: Sequence[Request],
    pools: Mapping[int, str],
    done_only: bool = False,
) -> Dict[str, Attainment]:
    """Attainment broken down by fleet pool label: ``pools`` maps rid ->
    worker label (`repro_torch.serving.disagg.DisaggSession.pool_labels`), so a
    disagg cell can report prefill-pool TTFT vs decode-pool TPOT attainment
    separately. Requests never placed on a worker (shed before placement,
    cancelled pre-prefill for the decode leg) group under ``"unassigned"``."""
    return attainment_by(
        requests, lambda r: pools.get(r.rid, "unassigned"), done_only=done_only
    )


def goodput(requests: Sequence[Request], span: Optional[float] = None) -> float:
    """SLO-met tokens/sec: generated tokens of completed requests that met
    their e2e SLO, over the trace span (first arrival -> last completion
    unless ``span`` is given). Shed and SLO-missing requests contribute 0."""
    good = [r for r in requests if r.phase == Phase.DONE and r.meets_e2e()]
    if not good:
        return 0.0
    if span is None:
        # completions only: a cancelled request's done_time records when the
        # client bailed, which must not stretch the serving span
        ends = [r.done_time for r in requests if r.phase == Phase.DONE]
        span = max(ends) - min(r.arrival for r in requests)
    if span <= 0:
        return 0.0
    return sum(r.n_generated for r in good) / span


def summarize(result: SimResult) -> Dict[str, float]:
    att = attainment(result.requests)
    out = att.as_dict()
    out.update(
        makespan=result.makespan,
        decode_steps=result.decode_steps,
        decode_tokens=result.decode_tokens,
        agg_decode_tput=(
            result.decode_tokens / result.decode_busy if result.decode_busy else 0.0
        ),
        prefill_busy=result.prefill_busy,
        decode_busy=result.decode_busy,
        goodput=goodput(result.requests, span=result.makespan or None),
    )
    done = [r for r in result.requests if r.phase == Phase.DONE]
    if done:
        out["ttft_p50"] = float(np.percentile([r.ttft() for r in done], 50))
        out["ttft_p99"] = float(np.percentile([r.ttft() for r in done], 99))
        tpots = [r.mean_tpot() for r in done if r.mean_tpot() is not None]
        out["tpot_p50"] = float(np.percentile(tpots, 50)) if tpots else 0.0
        out["tpot_p99"] = float(np.percentile(tpots, 99)) if tpots else 0.0
    return out


def compare(kairos: SimResult, baseline: SimResult) -> Dict[str, float]:
    """Headline deltas, paper-style (percentage points / relative %)."""
    ka, ba = attainment(kairos.requests), attainment(baseline.requests)
    return dict(
        ttft_gain_pp=100 * (ka.ttft - ba.ttft),
        tpot_gain_pp=100 * (ka.tpot - ba.tpot),
        e2e_gain_pp=100 * (ka.e2e - ba.e2e),
        decode_tput_gain_rel=(
            100 * (ka.decode_tput_p50 / ba.decode_tput_p50 - 1.0)
            if ba.decode_tput_p50
            else 0.0
        ),
    )
