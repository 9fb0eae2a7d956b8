"""Typed event taxonomy + the injectable `TraceRecorder`.

The taxonomy is the request lifecycle every backend shares:

    SUBMIT          request presented to admission control (t = declared
                    arrival — submission itself never reads a clock)
    ADMIT           admission control accepted it (prefix-hit accounting
                    rides in ``data`` when a PrefixCache is attached)
    SHED            admission control rejected it (``data["scope"]`` =
                    "global" | "tenant"); terminal, Phase.FAILED
    DEFLECT         disagg fleet: prefill deflected onto a decode worker
    ROUTE           router: replica chosen for the request
    PREFILL_START   first prefill chunk of the request begins
    PREFILL_END     prompt fully prefilled; first token exists
    HANDOFF_QUEUED  prefill→decode KV handoff enters the queue
    HANDOFF_START   handoff occupies an in-flight transfer slot
                    (``data["ready_at"]`` prices the wire time)
    HANDOFF_ATTACH  KV landed in a decode slot; decoding begins
    DECODE_STEP     one engine decode step (rid = -1: a pool-level event;
                    ``data``: batch, step_time, active, tpot_budget)
    TOKEN           one token produced for a request
    CANCEL          client withdrew the request (``data["stage"]`` says
                    where it was caught); terminal, Phase.CANCELLED
    DONE            request completed; terminal
    FAIL            engine crash containment tore the request down
                    (async frontend stepper crash); terminal

Fleet-control events (rid = -1 except RESTORE; `repro_torch.serving.fleetctl`):

    REPLICA_DOWN    a replica died (``data["reason"]``: "killed" |
                    "scale-down"; killed replicas carry recovery stats)
    REPLICA_UP      a replica joined the fleet (``data["warmed_blocks"]``:
                    prefix-trie nodes inherited from survivors)
    RESTORE         one in-flight request restored onto a survivor after
                    its replica died (rid-scoped; ``data``: src/dst
                    replica, tokens already delivered → stream splice
                    point). NOT a terminal — the survivor's DONE is.
    SCALE           an autoscaler decision was applied (``data``: policy,
                    action, n_before/n_after, the windowed-SLO evidence)

Every request reaches **exactly one** terminal event (`TERMINAL_EVENTS`),
however it dies — cancel-mid-handoff included. `counters_from_events`
rebuilds the `SessionMetrics` counters from the stream; equality against
the session's own accounting is pinned in tests/test_obs.py.

The recorder is deliberately dumb: an append-only in-memory list with no
clock, no thresholds, no sampling. Disabled tracing is ``trace=None`` at
the session — emission sites guard on that, so the disabled path allocates
nothing and the enabled path only appends (it never reads time itself,
which is what keeps ManualClock runs bit-identical with tracing on; see
the overhead guard in tests/test_obs.py).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional


class EventType(str, enum.Enum):
    SUBMIT = "submit"
    ADMIT = "admit"
    SHED = "shed"
    DEFLECT = "deflect"
    ROUTE = "route"
    PREFILL_START = "prefill_start"
    PREFILL_END = "prefill_end"
    HANDOFF_QUEUED = "handoff_queued"
    HANDOFF_START = "handoff_start"
    HANDOFF_ATTACH = "handoff_attach"
    DECODE_STEP = "decode_step"
    TOKEN = "token"
    CANCEL = "cancel"
    DONE = "done"
    FAIL = "fail"
    REPLICA_DOWN = "replica_down"
    REPLICA_UP = "replica_up"
    RESTORE = "restore"
    SCALE = "scale"


# the events after which a request will never produce another event
TERMINAL_EVENTS = frozenset(
    {EventType.SHED, EventType.CANCEL, EventType.DONE, EventType.FAIL}
)


@dataclass
class Event:
    """One trace record. ``t`` is *virtual* time from the emitter's injected
    Clock (sim cost-model time for the simulator) — never host wall time.
    ``pool`` is the emitting track: "engine:0", "replica:1", "prefill:0",
    "decode:1", or "sim". ``rid`` is -1 for pool-level events
    (DECODE_STEP)."""

    type: EventType
    t: float
    rid: int = -1
    tenant: str = ""
    pool: str = ""
    slot: Optional[int] = None
    data: Dict[str, Any] = field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        return dict(
            type=self.type.value,
            t=self.t,
            rid=self.rid,
            tenant=self.tenant,
            pool=self.pool,
            slot=self.slot,
            data=dict(self.data),
        )

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Event":
        return cls(
            type=EventType(d["type"]),
            t=float(d["t"]),
            rid=int(d.get("rid", -1)),
            tenant=d.get("tenant", ""),
            pool=d.get("pool", ""),
            slot=d.get("slot"),
            data=dict(d.get("data") or {}),
        )


class TraceRecorder:
    """Append-only in-memory event sink, injectable into every backend.

    Sessions default to ``trace=None`` (tracing off, zero cost); pass one
    recorder to as many sessions/pools as should share a timeline — the
    router hands the same recorder to every replica, the disagg fleet to
    every worker, each stamping its own ``pool`` label.
    """

    def __init__(self) -> None:
        self.events: List[Event] = []

    def emit(
        self,
        etype: EventType,
        t: float,
        rid: int = -1,
        tenant: str = "",
        pool: str = "",
        slot: Optional[int] = None,
        **data: Any,
    ) -> None:
        self.events.append(
            Event(type=etype, t=t, rid=rid, tenant=tenant, pool=pool, slot=slot, data=data)
        )

    def __len__(self) -> int:
        return len(self.events)

    def by_type(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for ev in self.events:
            counts[ev.type.value] = counts.get(ev.type.value, 0) + 1
        return counts

    def for_rid(self, rid: int) -> List[Event]:
        return [ev for ev in self.events if ev.rid == rid]

    def clear(self) -> None:
        self.events.clear()


def _bump(table: Dict[str, int], tenant: str) -> None:
    table[tenant] = table.get(tenant, 0) + 1


def counters_from_events(events: Iterable[Event]) -> Dict[str, Any]:
    """Rebuild the `SessionMetrics` counter block purely from the stream.

    The keys mirror `repro_torch.serving.session.SessionMetrics` (minus
    ``backpressure_shed``, which is a frontend-policy annotation the session
    counts separately — its cancels still appear here as CANCEL events).
    Equality against a live session's metrics is the cross-check test that
    every emission point fires exactly once per lifecycle transition.
    """
    out: Dict[str, Any] = dict(
        submitted=0,
        accepted=0,
        rejected=0,
        rejected_global=0,
        rejected_tenant=0,
        completed=0,
        cancelled=0,
        failed=0,
        deflected=0,
        rejected_rids=[],
        cancelled_rids=[],
        submitted_by_tenant={},
        rejected_by_tenant={},
        completed_by_tenant={},
        cancelled_by_tenant={},
        prefix_lookups=0,
        prefix_hits=0,
        prefix_hit_tokens=0,
        prefix_lookup_tokens=0,
    )
    for ev in events:
        if ev.type is EventType.SUBMIT:
            out["submitted"] += 1
            _bump(out["submitted_by_tenant"], ev.tenant)
        elif ev.type is EventType.ADMIT:
            out["accepted"] += 1
            if "prefix_eligible" in ev.data:
                out["prefix_lookups"] += 1
                out["prefix_lookup_tokens"] += ev.data["prefix_eligible"]
                hit = ev.data.get("prefix_hit", 0)
                out["prefix_hit_tokens"] += hit
                if hit:
                    out["prefix_hits"] += 1
        elif ev.type is EventType.SHED:
            out["rejected"] += 1
            out["rejected_rids"].append(ev.rid)
            _bump(out["rejected_by_tenant"], ev.tenant)
            if ev.data.get("scope") == "tenant":
                out["rejected_tenant"] += 1
            else:
                out["rejected_global"] += 1
        elif ev.type is EventType.DONE:
            out["completed"] += 1
            _bump(out["completed_by_tenant"], ev.tenant)
        elif ev.type is EventType.CANCEL:
            out["cancelled"] += 1
            out["cancelled_rids"].append(ev.rid)
            _bump(out["cancelled_by_tenant"], ev.tenant)
        elif ev.type is EventType.FAIL:
            out["failed"] += 1
        elif ev.type is EventType.DEFLECT:
            out["deflected"] += 1
    return out


def check_terminal_invariant(events: Iterable[Event]) -> Dict[int, List[str]]:
    """rid -> terminal event types seen. A well-formed stream has exactly
    one terminal per rid that ever reached SUBMIT; violations (0 for a
    drained run, or 2+, e.g. a double cancel) are what the invariant test
    hunts for."""
    seen: Dict[int, List[str]] = {}
    for ev in events:
        if ev.rid < 0:
            continue
        seen.setdefault(ev.rid, [])
        if ev.type in TERMINAL_EVENTS:
            seen[ev.rid].append(ev.type.value)
    return seen
