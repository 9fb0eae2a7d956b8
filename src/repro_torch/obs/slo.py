"""Event-stream SLO telemetry: timelines, attainment, sliding windows (a
copy of ``repro.obs.slo``).

Everything here is a pure fold over a `repro_torch.obs.events` stream — no
session, no clock, no Request objects. `per_request_timelines` rebuilds
each request's lifecycle; `attainment_from_events` recomputes the exact
`repro.sim.metrics.attainment` fractions from those timelines (pinned
equal in the JAX package's tests — the event stream carries everything the
aggregate metrics are made of); `windowed_slo` cuts the run into
fixed-width virtual-time windows and reports per-window attainment,
queue-depth and in-flight-transfer gauges, and the per-step
decode-time-vs-TPOT-budget series. That windowed block is the live
control signal the planned failover/autoscaling loop consumes (ROADMAP:
"SLO attainment under churn is the headline metric") — a replica scaler
reads the trailing window, not the end-of-run aggregate.

Attainment semantics mirror `repro.sim.metrics.attainment`: DONE plus
SHED/FAIL terminals form the denominator (a shed request is an SLO miss,
not a non-event), CANCEL is the client walking away — excluded from
numerator *and* denominator, surfaced as ``n_cancelled``.

TPOT caveat: events record token *generation* times; `Request.mean_tpot`
prefers delivery times when a `DeliveryPacer` reordered them. Under the
default ``"immediate"`` pacer the two are identical, which is the
configuration the equality tests pin.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from repro_torch.obs.events import Event, EventType, TERMINAL_EVENTS


@dataclass
class RequestTimeline:
    """One request's lifecycle, folded out of its events."""

    rid: int
    tenant: str = ""
    slo_class: str = ""
    arrival: float = 0.0
    input_len: int = 0
    output_len: int = 0
    slo_ttft: float = float("inf")
    slo_tpot: float = float("inf")
    pool: str = ""  # last pool that touched the request
    admit_t: Optional[float] = None
    prefill_start: Optional[float] = None
    prefill_end: Optional[float] = None
    handoff_queued: Optional[float] = None
    handoff_start: Optional[float] = None
    handoff_attach: Optional[float] = None
    token_times: List[float] = field(default_factory=list)
    terminal: Optional[str] = None  # "done" | "shed" | "cancel" | "fail"
    end_t: Optional[float] = None

    # --- mirrors of Request's metric methods (same None/0.0 conventions) --
    @property
    def first_token_time(self) -> Optional[float]:
        return self.token_times[0] if self.token_times else None

    def ttft(self) -> Optional[float]:
        ft = self.first_token_time
        return None if ft is None else ft - self.arrival

    def mean_tpot(self) -> Optional[float]:
        if not self.token_times:
            return None
        if len(self.token_times) < 2:
            return 0.0
        return (self.token_times[-1] - self.token_times[0]) / (len(self.token_times) - 1)

    def decode_tput(self) -> Optional[float]:
        ft = self.first_token_time
        if self.end_t is None or ft is None or self.terminal != "done":
            return None
        dur = self.end_t - ft
        if dur <= 0:
            return None
        return len(self.token_times) / dur

    def meets_ttft(self) -> bool:
        t = self.ttft()
        return t is not None and t <= self.slo_ttft

    def meets_tpot(self) -> bool:
        t = self.mean_tpot()
        return t is not None and t <= self.slo_tpot

    def meets_e2e(self) -> bool:
        return self.meets_ttft() and self.meets_tpot()


def per_request_timelines(events: Iterable[Event]) -> Dict[int, RequestTimeline]:
    """Fold the stream into rid -> `RequestTimeline` (pool-level events,
    rid == -1, are skipped)."""
    tls: Dict[int, RequestTimeline] = {}
    for ev in events:
        if ev.rid < 0:
            continue
        tl = tls.get(ev.rid)
        if tl is None:
            tl = tls[ev.rid] = RequestTimeline(rid=ev.rid, arrival=ev.t)
        if ev.tenant:
            tl.tenant = ev.tenant
        if ev.pool:
            tl.pool = ev.pool
        if ev.type is EventType.SUBMIT:
            d = ev.data
            tl.arrival = d.get("arrival", ev.t)
            tl.input_len = d.get("input_len", 0)
            tl.output_len = d.get("output_len", 0)
            tl.slo_ttft = d.get("slo_ttft", float("inf"))
            tl.slo_tpot = d.get("slo_tpot", float("inf"))
            tl.slo_class = d.get("slo_class", "")
        elif ev.type is EventType.ADMIT:
            tl.admit_t = ev.t
        elif ev.type is EventType.PREFILL_START:
            if tl.prefill_start is None:
                tl.prefill_start = ev.t
        elif ev.type is EventType.PREFILL_END:
            tl.prefill_end = ev.t
        elif ev.type is EventType.HANDOFF_QUEUED:
            tl.handoff_queued = ev.t
        elif ev.type is EventType.HANDOFF_START:
            tl.handoff_start = ev.t
        elif ev.type is EventType.HANDOFF_ATTACH:
            tl.handoff_attach = ev.t
        elif ev.type is EventType.TOKEN:
            tl.token_times.append(ev.t)
        elif ev.type in TERMINAL_EVENTS:
            tl.terminal = ev.type.value
            tl.end_t = ev.t
    return tls


def attainment_from_events(
    events: Iterable[Event], done_only: bool = False
) -> Dict[str, float]:
    """`sim.metrics.attainment(...).as_dict()` recomputed from the stream.

    DONE timelines carry the fractions; SHED and FAIL terminals are the
    ``Phase.FAILED`` misses diluting them; CANCEL is excluded from the
    denominator entirely. On a ManualClock run with the default immediate
    pacer this is *equal* (not approximately) to the session's own
    aggregate — the cross-check pinned in tests/test_obs.py.
    """
    tls = list(per_request_timelines(events).values())
    done = [t for t in tls if t.terminal == "done"]
    shed = [] if done_only else [t for t in tls if t.terminal in ("shed", "fail")]
    n_cancelled = sum(t.terminal == "cancel" for t in tls)
    n = len(done) + len(shed)
    if n == 0:
        return dict(
            ttft=0.0, tpot=0.0, e2e=0.0, decode_tput_p50=0.0,
            decode_tput_mean=0.0, n=0, n_shed=0, n_cancelled=n_cancelled,
        )
    tputs = [t for t in (tl.decode_tput() for tl in done) if t is not None]
    return dict(
        ttft=sum(t.meets_ttft() for t in done) / n,
        tpot=sum(t.meets_tpot() for t in done) / n,
        e2e=sum(t.meets_e2e() for t in done) / n,
        decode_tput_p50=float(np.percentile(tputs, 50)) if tputs else 0.0,
        decode_tput_mean=float(np.mean(tputs)) if tputs else 0.0,
        n=n,
        n_shed=len(shed),
        n_cancelled=n_cancelled,
    )


# CANCEL data["stage"] values that mean the request was still holding a
# prefill-queue entry / an in-flight transfer when the client bailed
# ("handoff" = queued-but-not-started, which never entered the window)
_QUEUE_STAGES = frozenset({"queue"})
_TRANSFER_STAGES = frozenset({"transfer", "inflight"})


def windowed_slo(events: Iterable[Event], window: float) -> Dict[str, Any]:
    """Cut the run into ``window``-second virtual-time windows.

    A request belongs to the window its *terminal* event lands in (that is
    when its TTFT/TPOT verdict exists). Gauges are folded event-by-event:
    queue depth rises on ADMIT and falls on PREFILL_END (or a queue-stage
    CANCEL); in-flight transfers rise on HANDOFF_START and fall on
    HANDOFF_ATTACH (or a transfer-stage CANCEL). DECODE_STEP events
    contribute the per-step decode-time series checked against the batch's
    tightest TPOT budget (``data["tpot_budget"]``).
    """
    evs = sorted(events, key=lambda e: e.t)
    if window <= 0:
        raise ValueError(f"slo window must be positive, got {window}")
    tls = per_request_timelines(evs)
    t_end = evs[-1].t if evs else 0.0
    n_windows = max(1, int(t_end / window) + 1) if evs else 0

    wins: List[Dict[str, Any]] = []
    for i in range(n_windows):
        wins.append(
            dict(
                t0=i * window,
                t1=(i + 1) * window,
                submitted=0,
                done=0,
                shed=0,
                cancelled=0,
                tokens=0,
                ttft=0.0,
                tpot=0.0,
                e2e=0.0,
                queue_depth_max=0,
                queue_depth_last=0,
                inflight_max=0,
                inflight_last=0,
                decode_steps=0,
                decode_time_mean=0.0,
                tpot_budget_violations=0,
            )
        )

    def wix(t: float) -> int:
        return min(n_windows - 1, max(0, int(t / window)))

    # per-window attainment numerators/denominators
    met = [[0, 0, 0] for _ in range(n_windows)]  # ttft, tpot, e2e hits
    denom = [0] * n_windows
    for tl in tls.values():
        if tl.terminal is None or tl.end_t is None:
            continue
        w = wins[wix(tl.end_t)]
        if tl.terminal == "done":
            w["done"] += 1
            i = wix(tl.end_t)
            denom[i] += 1
            met[i][0] += tl.meets_ttft()
            met[i][1] += tl.meets_tpot()
            met[i][2] += tl.meets_e2e()
        elif tl.terminal in ("shed", "fail"):
            w["shed"] += 1
            denom[wix(tl.end_t)] += 1
        else:
            w["cancelled"] += 1

    queue_depth = 0
    inflight = 0
    step_times: List[List[float]] = [[] for _ in range(n_windows)]
    for ev in evs:
        i = wix(ev.t)
        w = wins[i]
        if ev.type is EventType.SUBMIT:
            w["submitted"] += 1
        elif ev.type is EventType.TOKEN:
            w["tokens"] += 1
        elif ev.type is EventType.ADMIT:
            queue_depth += 1
        elif ev.type is EventType.PREFILL_END:
            queue_depth = max(0, queue_depth - 1)
        elif ev.type is EventType.HANDOFF_START:
            inflight += 1
        elif ev.type is EventType.HANDOFF_ATTACH:
            inflight = max(0, inflight - 1)
        elif ev.type is EventType.CANCEL:
            stage = ev.data.get("stage", "")
            if stage in _QUEUE_STAGES:
                queue_depth = max(0, queue_depth - 1)
            elif stage in _TRANSFER_STAGES:
                inflight = max(0, inflight - 1)
        elif ev.type is EventType.DECODE_STEP:
            w["decode_steps"] += 1
            st = ev.data.get("step_time", 0.0)
            step_times[i].append(st)
            budget = ev.data.get("tpot_budget", 0.0)
            if budget and st > budget:
                w["tpot_budget_violations"] += 1
        w["queue_depth_max"] = max(w["queue_depth_max"], queue_depth)
        w["queue_depth_last"] = queue_depth
        w["inflight_max"] = max(w["inflight_max"], inflight)
        w["inflight_last"] = inflight

    for i, w in enumerate(wins):
        if denom[i]:
            w["ttft"] = met[i][0] / denom[i]
            w["tpot"] = met[i][1] / denom[i]
            w["e2e"] = met[i][2] / denom[i]
        if step_times[i]:
            w["decode_time_mean"] = float(np.mean(step_times[i]))

    return dict(window=window, n_windows=n_windows, windows=wins)


def trace_cell_block(
    events: Iterable[Event], slo_window: Optional[float] = None
) -> Dict[str, Any]:
    """The ``trace`` block a harness cell embeds when tracing is enabled.

    Aggregates only — the raw stream goes to ``--trace PATH`` files, this
    block goes into the cell JSON (key set pinned by RPA005). The
    ``attainment`` sub-block is `attainment_from_events`; comparing it to
    the cell's own report is the standing cross-check that emission points
    fire once per lifecycle transition.
    """
    evs = list(events)
    by_type: Dict[str, int] = {}
    term_counts: Dict[int, int] = {}
    for ev in evs:
        by_type[ev.type.value] = by_type.get(ev.type.value, 0) + 1
        if ev.rid >= 0 and ev.type in TERMINAL_EVENTS:
            term_counts[ev.rid] = term_counts.get(ev.rid, 0) + 1
    tls = per_request_timelines(evs)
    multi_terminal = sum(1 for c in term_counts.values() if c > 1)
    out = dict(
        events=len(evs),
        requests=len(tls),
        by_type=by_type,
        attainment=attainment_from_events(evs),
        multi_terminal=multi_terminal,
    )
    if slo_window is not None:
        out["slo"] = windowed_slo(evs, slo_window)
    return out
