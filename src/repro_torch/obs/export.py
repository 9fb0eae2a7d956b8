"""Trace exporters: JSONL event log + Chrome trace-event / Perfetto JSON (a
copy of ``repro.obs.export``).

Two formats off one stream:

  * ``write_jsonl`` — one `Event.as_dict()` per line, lossless; round-trips
    through ``read_jsonl`` for offline analysis (`repro_torch.obs.slo` runs on the
    re-read stream unchanged).
  * ``write_chrome_trace`` — the Chrome trace-event JSON object format
    (``{"traceEvents": [...]}``) that https://ui.perfetto.dev and
    ``chrome://tracing`` load directly. Pools/replicas are *processes*,
    decode slots are *threads* (tid = slot + 1; tid 0 is the pool's
    scheduler track), and each request renders as three slices — prefill,
    handoff, decode — plus a TTFT flow arrow from its SUBMIT instant to its
    first TOKEN. Queue depth and in-flight transfers render as counter
    tracks. Given a recorder's ``spans``, each pool gets an ``engine``
    thread holding them as slices (the phases of its engine calls, with
    their device time), so the gaps a device trace shows can be put down
    to them.

``write_trace`` dispatches on the path suffix: ``.jsonl`` writes the event
log, anything else the Chrome JSON. Timestamps are emitted in microseconds
(the trace-event unit) from the events' virtual-time seconds; traceEvents
are sorted by timestamp (metadata first), so per-track timestamps are
monotone — the shape CI's smoke job validates.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.obs.events import Event, EventType, Span

# instants worth a mark on the scheduler track
_INSTANT_TYPES = (
    EventType.SUBMIT,
    EventType.SHED,
    EventType.DEFLECT,
    EventType.ROUTE,
    EventType.CANCEL,
    EventType.FAIL,
    EventType.REPLICA_DOWN,
    EventType.REPLICA_UP,
    EventType.RESTORE,
    EventType.SCALE,
)


def write_jsonl(events: Iterable[Event], path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for ev in events:
            f.write(json.dumps(ev.as_dict(), sort_keys=True) + "\n")


def read_jsonl(path: str) -> List[Event]:
    out: List[Event] = []
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(Event.from_dict(json.loads(line)))
            except (ValueError, KeyError) as e:
                raise ValueError(f"{path}:{i}: malformed trace event: {e}") from None
    return out


def _us(t: float) -> float:
    return t * 1e6


# the thread of a pool's engine spans, after any slot's
_ENGINE_TID = 1 << 20


def _pid_table(events: Sequence[Event], spans: Sequence[Span] = ()) -> Dict[str, int]:
    """Stable pool-label -> pid assignment (sorted; '' last as 'session')."""
    labels = sorted({ev.pool for ev in events} | {s.pool for s in spans})
    return {label: i + 1 for i, label in enumerate(labels)}


def _tid(ev: Event) -> int:
    return 0 if ev.slot is None else ev.slot + 1


def chrome_trace(events: Sequence[Event], spans: Sequence[Span] = ()) -> Dict[str, Any]:
    """Build the Chrome trace-event JSON object for one event stream and,
    if given, the recorder's spans."""
    pids = _pid_table(events, spans)
    out: List[Dict[str, Any]] = []

    # ---- metadata: name every process and thread we will reference ------
    tids_by_pid: Dict[int, set] = {}
    for ev in events:
        tids_by_pid.setdefault(pids[ev.pool], set()).add(_tid(ev))
    for sp in spans:
        tids_by_pid.setdefault(pids[sp.pool], set()).add(_ENGINE_TID)
    for label, pid in pids.items():
        out.append(
            dict(
                name="process_name", ph="M", pid=pid, tid=0, ts=0.0,
                args=dict(name=label or "session"),
            )
        )
        for tid in sorted(tids_by_pid.get(pid, {0})):
            out.append(
                dict(
                    name="thread_name", ph="M", pid=pid, tid=tid, ts=0.0,
                    args=dict(name="scheduler" if tid == 0 else "engine"
                              if tid == _ENGINE_TID else f"slot {tid - 1}"),
                )
            )

    # ---- per-request phase boundaries (for the three slices + TTFT flow)
    start_of: Dict[Tuple[int, str], Event] = {}
    first_token: Dict[int, Event] = {}
    submit: Dict[int, Event] = {}
    body: List[Dict[str, Any]] = []
    queue_depth = 0
    inflight = 0

    def slice_ev(name: str, a: Event, b: Event, *, tid: Optional[int] = None,
                 args: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        return dict(
            name=name, cat="request", ph="X",
            ts=_us(a.t), dur=max(0.0, _us(b.t) - _us(a.t)),
            pid=pids[b.pool], tid=_tid(b) if tid is None else tid,
            args=dict(rid=a.rid, **(args or {})),
        )

    for ev in events:
        pid, tid = pids[ev.pool], _tid(ev)
        if ev.type in _INSTANT_TYPES:
            body.append(
                dict(
                    name=f"{ev.type.value} r{ev.rid}", cat="lifecycle", ph="i",
                    ts=_us(ev.t), pid=pid, tid=tid, s="t",
                    args=dict(rid=ev.rid, tenant=ev.tenant, **ev.data),
                )
            )
        if ev.type is EventType.SUBMIT:
            submit[ev.rid] = ev
        elif ev.type is EventType.PREFILL_START:
            start_of[(ev.rid, "prefill")] = ev
        elif ev.type is EventType.PREFILL_END:
            a = start_of.pop((ev.rid, "prefill"), None)
            if a is not None:
                body.append(slice_ev(f"prefill r{ev.rid}", a, ev))
        elif ev.type is EventType.HANDOFF_START:
            start_of[(ev.rid, "handoff")] = ev
            inflight += 1
            body.append(
                dict(
                    name="inflight_transfers", ph="C", ts=_us(ev.t),
                    pid=pid, tid=0, args=dict(value=inflight),
                )
            )
        elif ev.type is EventType.HANDOFF_ATTACH:
            a = start_of.pop((ev.rid, "handoff"), None)
            if a is not None:
                body.append(
                    slice_ev(f"handoff r{ev.rid}", a, ev,
                             args=dict(dst=ev.pool))
                )
            start_of[(ev.rid, "decode")] = ev
            inflight = max(0, inflight - 1)
            body.append(
                dict(
                    name="inflight_transfers", ph="C", ts=_us(ev.t),
                    pid=pid, tid=0, args=dict(value=inflight),
                )
            )
        elif ev.type is EventType.TOKEN:
            if ev.rid not in first_token:
                first_token[ev.rid] = ev
                sub = submit.get(ev.rid)
                if sub is not None:
                    # TTFT flow arrow: submit instant -> first token
                    fid = ev.rid + 1  # flow ids must be non-zero
                    body.append(
                        dict(
                            name="ttft", cat="slo", ph="s", id=fid,
                            ts=_us(sub.t), pid=pids[sub.pool], tid=_tid(sub),
                            args=dict(rid=ev.rid),
                        )
                    )
                    body.append(
                        dict(
                            name="ttft", cat="slo", ph="f", bp="e", id=fid,
                            ts=_us(ev.t), pid=pid, tid=tid,
                            args=dict(rid=ev.rid, ttft=ev.t - sub.data.get("arrival", sub.t)),
                        )
                    )
        elif ev.type in (EventType.DONE, EventType.CANCEL, EventType.FAIL):
            a = start_of.pop((ev.rid, "decode"), None)
            if a is not None:
                body.append(
                    slice_ev(f"decode r{ev.rid}", a, ev, tid=_tid(a),
                             args=dict(outcome=ev.type.value))
                )
        elif ev.type is EventType.DECODE_STEP:
            body.append(
                dict(
                    name="decode_step", cat="engine", ph="i",
                    ts=_us(ev.t), pid=pid, tid=tid, s="p",
                    args=dict(ev.data),
                )
            )
        # queue-depth gauge: sessions sample it into ADMIT / PREFILL_END data
        if "queue_depth" in ev.data:
            queue_depth = ev.data["queue_depth"]
            body.append(
                dict(
                    name="queue_depth", ph="C", ts=_us(ev.t),
                    pid=pid, tid=0, args=dict(value=queue_depth),
                )
            )

    for sp in spans:  # one engine call's phases are contiguous, never nested
        args = dict(sp.data)
        if sp.device_s is not None:
            args["device_ms"] = sp.device_s * 1e3
        body.append(
            dict(
                name=sp.name, cat="span", ph="X",
                ts=_us(sp.t0), dur=max(0.0, _us(sp.t1) - _us(sp.t0)),
                pid=pids[sp.pool], tid=_ENGINE_TID, args=args,
            )
        )

    body.sort(key=lambda e: e["ts"])
    other = dict(generator="repro_torch.obs", events=len(events))
    if spans:
        other["spans"] = len(spans)
    return dict(traceEvents=out + body, displayTimeUnit="ms", otherData=other)


def write_chrome_trace(events: Sequence[Event], path: str, spans: Sequence[Span] = ()) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(chrome_trace(events, spans), f, indent=1, sort_keys=True)
        f.write("\n")


def write_trace(events: Sequence[Event], path: str, spans: Sequence[Span] = ()) -> str:
    """Write ``path`` in the format its suffix implies: ``.jsonl`` = raw
    event log (events only), anything else = Chrome trace-event JSON, with
    ``spans`` on the engine threads. Returns the format written ("jsonl" |
    "chrome")."""
    if str(path).endswith(".jsonl"):
        write_jsonl(events, path)
        return "jsonl"
    write_chrome_trace(events, path, spans)
    return "chrome"
