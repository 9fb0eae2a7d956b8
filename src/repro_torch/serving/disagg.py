"""Fleet-level P/D disaggregation: prefill pool + decode pool + KV handoff
(port of ``repro.serving.disagg``; the reference's per-step key split is the
server's own `torch.Generator`, as in `ServeSession.step`).

`RouterSession` (repro_torch.serving.router) fronts N *whole* replicas; this
module splits the fleet the way production disaggregated systems do (SGLang
PD disaggregation, SNIPPETS.md): a **prefill pool** of servers that only run
chunked prefill, a **decode pool** that only decodes, and an explicit
**KV handoff** stage between them —

    submit -> [deflection decision] -> prefill worker queue
           -> chunked prefill (prefill pool, or a decode worker if deflected)
           -> handoff queue -> bounded in-flight transfer window
              (decode slot reserved at transfer START; KV priced by
               CostModel.transfer_time = lat + tokens*bytes/bw; the real
               slot-to-slot copy lands at completion)
           -> decode worker active set -> tokens stream out

Handoff state machine (DESIGN.md §disagg): a prefill-finished request is
*queued* the instant its prompt completes; it *starts* when the in-flight
window has room AND a decode slot reserves (destination = least-loaded
decode worker; the prefilling worker itself for deflected requests); it
*completes* — KV scattered into the reserved slot, request decoding — once
`transfer_time` has elapsed on the fleet clock. Starts that fail (window
full or no slot) park in the handoff queue and retry every step: handoff
backpressure is a first-class scheduling signal (`HandoffMetrics.queue_*`).

**Prefill deflection** (Microsoft's load-aware prefill deflection,
PAPERS.md) is the policy axis the split unlocks: under prefill-pool
pressure, short prompts prefill directly on an underutilized decode server
— their handoff is then local (no cross-server copy). Policies live in the
fourth registry side (`repro_torch.policies.deflection`; `@register_deflection`)
and consume *this* session as their fleet view.

`DisaggSession` duck-types `ServeSession` (submit/step/cancel/outputs/
metrics/summary + a `server` facade), so `DisaggFleetSession` reuses the
whole `AsyncServeSession` machinery — streaming handles, backpressure,
cancellation, open-loop replay — via frontend session injection.

Determinism: every server in the fleet shares ONE clock (enforced), the
fleet's `_now()`/`reset_clock()` read it exactly like a single
`DisaggServer`, and `step()` mirrors `ServeSession.step` read-for-read per
worker — so a 1P:1D fleet under `never` deflection reproduces a single
replica's TTFT/TPOT bit-for-bit on a `ManualClock` (pinned in
tests/test_torch_disagg.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.request import Phase, Request
from repro_torch.obs.events import EventType, TraceRecorder
from repro_torch.policies import PolicySpec, make_deflection
from repro_torch.serving.engine import DisaggServer, LiveRequest
from repro_torch.serving.frontend import AsyncServeSession
from repro_torch.serving.session import FROM_CONFIG, SessionMetrics

TokenCallback = Callable[[Request, int, float], None]


@dataclass
class HandoffMetrics:
    """KV-handoff counters for one fleet session's lifetime."""

    transfers_started: int = 0
    transfers_completed: int = 0
    transfers_cancelled: int = 0  # cancelled while queued or in flight
    cross_transfers: int = 0  # prefill-pool -> decode-pool copies
    local_transfers: int = 0  # deflected: KV already on the decode server
    bytes_transferred: float = 0.0  # input_len * kv_bytes_per_token, started
    queue_wait_total: float = 0.0  # virtual seconds spent queued-not-started
    queue_wait_max: float = 0.0
    queued_peak: int = 0  # high-water mark of the handoff queue
    inflight_peak: int = 0  # high-water mark of the transfer window


@dataclass
class PoolWorker:
    """One server's slot in a pool, plus the fleet's live view of it.

    The view properties are what deflection policies consult — pure reads
    of request/allocator state, no clock access, so decisions replay.
    """

    server: DisaggServer
    label: str  # "prefill:0" / "decode:1" — the pool label in reports
    pool: str  # "prefill" | "decode"
    queue: List[LiveRequest] = field(default_factory=list)  # awaiting/in prefill
    active: List[LiveRequest] = field(default_factory=list)  # decoding (decode pool)
    assigned: int = 0  # lifetime placements, the idle-pool round-robin tiebreak

    @property
    def queue_len(self) -> int:
        return len(self.queue)

    @property
    def pending_prefill_tokens(self) -> int:
        """Prompt tokens queued on this worker whose prefill hasn't run —
        the backlog signal deflection watermarks trigger on."""
        return sum(lr.req.remaining_prefill_tokens for lr in self.queue)

    @property
    def mu(self) -> float:
        """The server's online prefill-throughput estimate (tokens/s)."""
        return self.server.mu.mu

    @property
    def free_slots(self) -> int:
        return len(self.server.decode.alloc.free)


@dataclass
class _Transfer:
    """One KV handoff moving through queued -> in-flight -> attached."""

    lr: LiveRequest
    src: PoolWorker
    queued_at: float
    dst: Optional[PoolWorker] = None  # chosen (and slot reserved) at start
    started_at: Optional[float] = None
    ready_at: Optional[float] = None  # started_at + cost.transfer_time


class _FleetClock:
    """The fleet's single-server disguise for timing purposes.

    `AsyncServeSession`'s stepper and the session metrics only need
    ``server.clock`` / ``_now()`` / ``reset_clock()``; this facade provides
    them over the *shared* fleet clock so the whole fleet advances one
    timeline. All servers must share one Clock instance — per-server clocks
    would let `monotonic()` auto-steps diverge between pools and destroy
    replay determinism.
    """

    def __init__(self, servers: Sequence[DisaggServer]):
        if not servers:
            raise ValueError("disagg fleet needs at least one server")
        if len({id(s.clock) for s in servers}) != 1:
            raise ValueError(
                "disagg fleet servers must share one Clock instance; "
                "per-server clocks desynchronize the pools"
            )
        self.servers = list(servers)
        self.clock = self.servers[0].clock
        self.ecfg = self.servers[0].ecfg
        self.cost = self.servers[0].cost
        self.reset_clock()

    def _now(self) -> float:
        return self.servers[0]._now()

    def reset_clock(self) -> None:
        """Re-zero virtual time for the whole fleet via ONE reset — N
        per-server resets of a wall clock would skew the pools by the gap
        between reads. The single `DisaggServer.reset_clock` carries the
        virtual-clock exact-zero rule; the others just copy its origin."""
        self.servers[0].reset_clock()
        for s in self.servers[1:]:
            s._t0 = self.servers[0]._t0


class DisaggSession:
    """The fleet-level serve loop over a prefill pool and a decode pool.

    Duck-types `ServeSession` — same submit/step/cancel/outputs/metrics/
    summary surface, same per-step clock discipline — over P+D servers.
    Also *is* the fleet view deflection policies receive: ``prefill_pool``,
    ``decode_pool`` (PoolWorker views) and ``decode_has_capacity()``.
    """

    def __init__(
        self,
        prefill_servers: Sequence[DisaggServer],
        decode_servers: Sequence[DisaggServer],
        deflection: Union[str, PolicySpec] = "never",
        max_queue_depth: Any = FROM_CONFIG,
        tenant_queue_depth: Any = FROM_CONFIG,
        on_token: Optional[TokenCallback] = None,
        max_inflight_transfers: int = 8,
        trace: Optional[TraceRecorder] = None,
        trace_label: str = "fleet",
    ):
        if not prefill_servers or not decode_servers:
            raise ValueError("disagg fleet needs >= 1 prefill and >= 1 decode server")
        if max_inflight_transfers < 1:
            raise ValueError("max_inflight_transfers must be >= 1")
        self.server = _FleetClock(list(prefill_servers) + list(decode_servers))
        self.ecfg = self.server.ecfg
        if max_queue_depth is FROM_CONFIG:
            max_queue_depth = self.ecfg.admission_queue_depth
        self.max_queue_depth = max_queue_depth  # None = unbounded, per worker
        if tenant_queue_depth is FROM_CONFIG:
            tenant_queue_depth = self.ecfg.tenant_queue_depth
        self.tenant_queue_depth = tenant_queue_depth
        self.prefill_pool = [
            PoolWorker(s, f"prefill:{i}", "prefill")
            for i, s in enumerate(prefill_servers)
        ]
        self.decode_pool = [
            PoolWorker(s, f"decode:{i}", "decode")
            for i, s in enumerate(decode_servers)
        ]
        self.deflect = make_deflection(deflection)
        self.max_inflight_transfers = max_inflight_transfers
        self.pending_handoff: List[_Transfer] = []  # queued, not yet started
        self.inflight: List[_Transfer] = []  # started, KV on the wire

        self.outputs: Dict[int, List[int]] = {}
        self.requests: List[Request] = []
        self.metrics = SessionMetrics()
        self.handoff = HandoffMetrics()
        self.deflected = 0
        self.deflected_rids: List[int] = []
        self._deflected_by_dst: Dict[str, int] = {}
        # rid -> worker label: where prefill ran / where decode ran (the
        # pool labels per-pool attainment groups by)
        self._prefill_worker_of: Dict[int, str] = {}
        self._decode_worker_of: Dict[int, str] = {}
        # paged fleets: rid -> the decode worker whose radix cache matched
        # the prompt at submit. The request's shared pages live in THAT
        # worker's pool, so its handoff must land there (enforced in
        # `_start_transfer`) and its pins release there (`_finish_cancel`
        # or decode completion).
        self._kv_dst: Dict[int, PoolWorker] = {}
        self.on_token = on_token
        self._callbacks: Dict[int, TokenCallback] = {}
        # observability (repro_torch.obs): one recorder shared by every worker,
        # each event stamped with the emitting worker's pool label
        # ("prefill:0" / "decode:1"); session-level events (SUBMIT) carry
        # `trace_label`. None = tracing off.
        self.trace = trace
        self.trace_label = trace_label

    # --------------------------------------------------------- fleet view
    @property
    def paged(self) -> bool:
        return self.decode_pool[0].server.decode.paged

    def decode_has_capacity(self) -> bool:
        """Some decode worker can absorb a deflected prefill: free decode
        slots exceed its already-deflected backlog (the natural watermark —
        deflection must not out-queue the capacity that attracted it)."""
        return any(w.free_slots > w.queue_len for w in self.decode_pool)

    def pool_labels(self) -> Dict[str, Dict[int, str]]:
        """rid -> worker label, for the prefill and decode legs (deflected
        requests carry a decode-pool label in both)."""
        return dict(
            prefill=dict(self._prefill_worker_of),
            decode=dict(self._decode_worker_of),
        )

    def _pick_prefill_worker(self, request: Request) -> PoolWorker:
        """Join-shortest-token-backlog with a least-assigned tiebreak.

        Backlog (not a mu-scaled ETA) is the primary key: per-server mu
        estimates drift apart as one worker sees more traffic, and an
        ETA key then routes *everything* to the historically faster
        worker. The ``assigned`` tiebreak round-robins the common case of
        a fully drained pool instead of letting the label tiebreak pin
        every idle-time arrival to worker 0."""
        return min(
            self.prefill_pool,
            key=lambda w: (
                w.pending_prefill_tokens,
                w.queue_len,
                w.assigned,
                w.label,
            ),
        )

    def _pick_deflection_worker(self) -> PoolWorker:
        """Underutilized decode worker for a deflected prefill: most spare
        slots after its current load, label tiebreak."""
        return min(
            self.decode_pool,
            key=lambda w: (self._dst_load(w) - w.free_slots, self._dst_load(w), w.label),
        )

    def _dst_load(self, w: PoolWorker) -> int:
        """Requests a handoff to `w` would queue behind: decoding + deflected
        prefills + transfers already bound for it."""
        return (
            len(w.active)
            + len(w.queue)
            + sum(1 for tr in self.inflight if tr.dst is w)
        )

    # ------------------------------------------------------------- submit
    def submit(
        self,
        request: Request,
        prompt: Sequence[int],
        on_token: Optional[TokenCallback] = None,
    ) -> bool:
        """Place a request on a worker (deflection decides which pool);
        returns False and sheds it when the chosen worker's queue is at
        ``max_queue_depth`` or the tenant quota is hit — the same per-queue
        admission rule `ServeSession.submit` applies to its single queue."""
        if request.input_len != len(prompt):
            raise ValueError(
                f"request rid={request.rid} declares input_len={request.input_len} "
                f"but prompt has {len(prompt)} tokens; the SLO/urgency arithmetic "
                f"is computed from input_len, so they must agree"
            )
        m = self.metrics
        m.submitted += 1
        m._bump(m.submitted_by_tenant, request.tenant)
        self.requests.append(request)
        tr = self.trace
        if tr is not None:
            # t = declared arrival — submit paths never read the fleet clock
            tr.emit(
                EventType.SUBMIT, request.arrival, rid=request.rid,
                tenant=request.tenant, pool=self.trace_label,
                arrival=request.arrival, input_len=request.input_len,
                output_len=request.output_len, slo_ttft=request.slo.ttft,
                slo_tpot=request.slo.tpot, slo_class=request.slo_class,
            )
        # paged fleets probe every decode worker's radix cache for the
        # longest live-page prefix BEFORE placement: a hit fixes the
        # request's decode destination (the pages are physically in that
        # worker's pool) and lets its prefill skip the cached head. Pure
        # peeks — no insertion, no clock reads — so shed requests leave no
        # trace. First-worker wins ties, keeping placement deterministic.
        kv_dst: Optional[PoolWorker] = None
        kv_hit = 0
        kv_pages = ()
        if self.paged:
            for w in self.decode_pool:
                hit, pages = w.server.decode.prefix.match_pages(prompt)
                if hit > kv_hit:
                    kv_dst, kv_hit, kv_pages = w, hit, pages
        deflected = self.deflect.decide(self, request, prompt)
        if deflected and kv_dst is not None:
            # deflect onto the worker that already holds the prefix pages:
            # prefill AND decode both stay local to the KV
            target = kv_dst
        elif deflected:
            target = self._pick_deflection_worker()
        else:
            target = self._pick_prefill_worker(request)
        shed_global = (
            self.max_queue_depth is not None
            and target.queue_len >= self.max_queue_depth
        )
        shed_tenant = False
        if not shed_global and self.tenant_queue_depth is not None:
            queued = sum(1 for lr in target.queue if lr.req.tenant == request.tenant)
            shed_tenant = queued >= self.tenant_queue_depth
        if shed_global or shed_tenant:
            request.phase = Phase.FAILED
            m.rejected += 1
            if shed_global:
                m.rejected_global += 1
            else:
                m.rejected_tenant += 1
            m.rejected_rids.append(request.rid)
            m._bump(m.rejected_by_tenant, request.tenant)
            if tr is not None:
                tr.emit(
                    EventType.SHED, request.arrival, rid=request.rid,
                    tenant=request.tenant, pool=target.label,
                    scope="global" if shed_global else "tenant",
                    queue_depth=target.queue_len,
                )
            return False
        m.accepted += 1
        if tr is not None and deflected:
            # DEFLECT precedes ADMIT: the placement decision is made before
            # the worker's queue accepts the request (only accepted requests
            # count as deflected — a deflected-then-shed one does not)
            tr.emit(
                EventType.DEFLECT, request.arrival, rid=request.rid,
                tenant=request.tenant, pool=target.label,
                policy=self.deflect.name,
            )
        lr = LiveRequest(req=request, tokens=list(prompt))
        if self.paged:
            m.prefix_lookups += 1
            block = self.decode_pool[0].server.decode.page_size
            m.prefix_lookup_tokens += (len(prompt) // block) * block
            if kv_dst is not None:
                # pin the matched path on the owning worker until the
                # request leaves the fleet, and carry the shared pages so
                # prefill seeds from (and reserve links into) its pool
                kv_dst.server.decode.prefix.pin_match(prompt, request.rid)
                request.prefix_hit_tokens = kv_hit
                request.prefix_cached_tokens = kv_hit
                lr.shared_pages = kv_pages
                lr.kv_src = kv_dst.server.decode
                self._kv_dst[request.rid] = kv_dst
                m.prefix_hits += 1
                m.prefix_hit_tokens += kv_hit
                m.prefix_cached_tokens += kv_hit
        target.queue.append(lr)
        target.assigned += 1
        self._prefill_worker_of[request.rid] = target.label
        if tr is not None:
            tr.emit(
                EventType.ADMIT, request.arrival, rid=request.rid,
                tenant=request.tenant, pool=target.label,
                queue_depth=target.queue_len,
            )
        if deflected:
            self.deflected += 1
            self.deflected_rids.append(request.rid)
            d = self._deflected_by_dst
            d[target.label] = d.get(target.label, 0) + 1
        if on_token is not None:
            self._callbacks[request.rid] = on_token
        return True

    # ------------------------------------------------------------- cancel
    def cancel(self, rid: int) -> bool:
        """Withdraw an in-flight request wherever it lives: a worker's
        prefill queue, the handoff queue, the in-flight transfer window
        (the reserved decode slot is released), or a decode active set.
        Terminal in ``Phase.CANCELLED``; no slot leaks in either pool."""
        for w in (*self.prefill_pool, *self.decode_pool):
            for lr in w.queue:
                if lr.req.rid == rid:
                    w.queue.remove(lr)
                    lr.prefill_cache = None
                    self._finish_cancel(lr, "queue", w.label)
                    return True
            for lr in w.active:
                if lr.req.rid == rid:
                    w.active.remove(lr)
                    slot = lr.slot
                    w.server.decode.release(lr)
                    self._finish_cancel(lr, "decode", w.label, slot=slot)
                    return True
        for tr in self.pending_handoff:
            if tr.lr.req.rid == rid:
                self.pending_handoff.remove(tr)
                tr.lr.prefill_cache = None
                self.handoff.transfers_cancelled += 1
                self._finish_cancel(tr.lr, "handoff", tr.src.label)
                return True
        for tr in self.inflight:
            if tr.lr.req.rid == rid:
                self.inflight.remove(tr)
                tr.dst.server.decode.release(tr.lr)  # reserved at start
                tr.lr.prefill_cache = None
                self.handoff.transfers_cancelled += 1
                self._finish_cancel(tr.lr, "inflight", tr.dst.label)
                return True
        return False

    def _finish_cancel(
        self, lr: LiveRequest, stage: str, pool: str, slot: Optional[int] = None
    ) -> None:
        # queue/handoff-stage cancels never reach decode.release on the
        # pinning worker, so the radix unpin happens here (idempotent)
        kv_dst = self._kv_dst.pop(lr.req.rid, None)
        if kv_dst is not None:
            kv_dst.server.decode.prefix.release(lr.req.rid)
        lr.req.phase = Phase.CANCELLED
        lr.req.done_time = self.server._now()
        self._callbacks.pop(lr.req.rid, None)
        m = self.metrics
        m.cancelled += 1
        m.cancelled_rids.append(lr.req.rid)
        m._bump(m.cancelled_by_tenant, lr.req.tenant)
        if self.trace is not None:
            # every cancel path funnels here, so a cancel — mid-handoff
            # included — emits exactly one terminal event
            self.trace.emit(
                EventType.CANCEL, lr.req.done_time, rid=lr.req.rid,
                tenant=lr.req.tenant, pool=pool, slot=slot, stage=stage,
            )

    # -------------------------------------------------------------- state
    @property
    def has_work(self) -> bool:
        return bool(
            self.pending_handoff
            or self.inflight
            or any(w.queue or w.active for w in (*self.prefill_pool, *self.decode_pool))
        )

    def _emit(self, req: Request, tok: int, t: float) -> None:
        self.outputs.setdefault(req.rid, []).append(tok)
        cb = self._callbacks.get(req.rid)
        if cb is not None:
            cb(req, tok, t)
        if self.on_token is not None:
            self.on_token(req, tok, t)

    # ------------------------------------------------------------ handoff
    def _start_transfer(self, tr: _Transfer, at: float) -> bool:
        """Try to move a queued handoff into the in-flight window: needs
        window room and a reserved decode slot. Destination is the least
        loaded decode worker (the prefilling worker itself when deflected —
        its KV never crosses servers)."""
        if len(self.inflight) >= self.max_inflight_transfers:
            return False
        kv_dst = self._kv_dst.get(tr.lr.req.rid)
        if kv_dst is not None:
            # shared prefix pages are physically in this worker's pool;
            # landing anywhere else would orphan them (a foreign pool can't
            # link them). Park and retry rather than fall through.
            candidates = [kv_dst]
        elif tr.src.pool == "decode":
            candidates = [tr.src]
        else:
            candidates = sorted(
                self.decode_pool, key=lambda w: (self._dst_load(w), w.label)
            )
        for dst in candidates:
            if dst.server.decode.reserve(tr.lr):
                break
        else:
            return False
        tr.dst = dst
        tr.started_at = at
        # cached-prefix pages never cross the wire — only computed tokens
        # are priced (prefix_cached_tokens is 0 on non-paged fleets)
        tr.ready_at = at + tr.src.server.cost.transfer_time(
            tr.lr.req.input_len - tr.lr.req.prefix_cached_tokens
        )
        tr.lr.transfer_ready_at = tr.ready_at
        self.inflight.append(tr)
        self._decode_worker_of[tr.lr.req.rid] = dst.label
        if self.trace is not None:
            self.trace.emit(
                EventType.HANDOFF_START, at, rid=tr.lr.req.rid,
                tenant=tr.lr.req.tenant, pool=dst.label, slot=tr.lr.slot,
                src=tr.src.label, ready_at=tr.ready_at,
            )
        h = self.handoff
        h.transfers_started += 1
        if dst is tr.src:
            h.local_transfers += 1
        else:
            h.cross_transfers += 1
        h.bytes_transferred += (
            tr.lr.req.input_len - tr.lr.req.prefix_cached_tokens
        ) * self.ecfg.kv_bytes_per_token
        wait = max(0.0, at - tr.queued_at)
        h.queue_wait_total += wait
        h.queue_wait_max = max(h.queue_wait_max, wait)
        h.inflight_peak = max(h.inflight_peak, len(self.inflight))
        return True

    def _enqueue_handoff(self, lr: LiveRequest, src: PoolWorker, at: float) -> None:
        tr = _Transfer(lr=lr, src=src, queued_at=at)
        if self.trace is not None:
            self.trace.emit(
                EventType.HANDOFF_QUEUED, at, rid=lr.req.rid,
                tenant=lr.req.tenant, pool=src.label,
            )
        if not self._start_transfer(tr, at):
            self.pending_handoff.append(tr)
            self.handoff.queued_peak = max(
                self.handoff.queued_peak, len(self.pending_handoff)
            )

    # ---------------------------------------------------------------- step
    def step(self) -> List[int]:
        """Advance the fleet one round; returns rids completed this round.

        Per-worker stage bodies mirror `ServeSession.step` *read-for-read*
        (same clock calls in the same order per worker) — the basis of the
        1P:1D bit-parity contract. Do not add or reorder clock reads here
        without updating that test.
        """
        ecfg = self.ecfg
        clock = self.server.clock
        completed: List[int] = []
        now = self.server._now()

        # ---- prefill stage: the prefill pool, then deflected prompts on
        # decode workers (a deflected prefill runs the same chunked loop,
        # just on a decode server's prefill engine)
        trc = self.trace
        for w in (*self.prefill_pool, *self.decode_pool):
            if not w.queue:
                continue
            srv = w.server
            pq = [lr.req for lr in w.queue]
            sel = srv.prefill_sched.select(pq, now, srv.mu.mu, ecfg.chunk_size)
            t0 = clock.monotonic()
            total = 0
            for req, take in sel:
                lr = next(l for l in w.queue if l.req is req)
                if trc is not None and req.prefilled_tokens == 0:
                    trc.emit(
                        EventType.PREFILL_START, now, rid=req.rid,
                        tenant=req.tenant, pool=w.label, take=take,
                    )
                logits = srv.prefill.run_chunk(lr, take)
                total += take
                if logits is not None:
                    fin = srv._now()
                    req.prefill_finish = fin
                    req.first_token_time = fin
                    tok = int(np.argmax(logits))
                    lr.tokens.append(tok)
                    req.n_generated = 1
                    req.token_times.append(fin)
                    req.phase = Phase.TRANSFER
                    w.queue.remove(lr)
                    if trc is not None:
                        trc.emit(
                            EventType.PREFILL_END, fin, rid=req.rid,
                            tenant=req.tenant, pool=w.label,
                            queue_depth=len(w.queue),
                        )
                    self._enqueue_handoff(lr, w, fin)
                    if trc is not None:
                        trc.emit(
                            EventType.TOKEN, fin, rid=req.rid,
                            tenant=req.tenant, pool=w.label,
                        )
                    self._emit(req, tok, fin)
            elapsed = (clock.monotonic() - t0) * ecfg.time_scale
            self.metrics.prefill_computed_tokens += total
            if total:
                srv.mu.update(total, max(elapsed, 1e-9))

        # ---- handoff completions (the fleet's admission sweep) ----------
        admitted = False
        for tr in list(self.inflight):
            if now < tr.ready_at:
                continue  # KV still on the wire
            self.inflight.remove(tr)
            lr = tr.lr
            tr.dst.server.decode.attach(lr)  # the real slot-to-slot copy
            lr.req.phase = Phase.DECODE
            lr.req.decode_start = self.server._now()
            tr.dst.active.append(lr)
            self.handoff.transfers_completed += 1
            admitted = True
            if trc is not None:
                trc.emit(
                    EventType.HANDOFF_ATTACH, lr.req.decode_start,
                    rid=lr.req.rid, tenant=lr.req.tenant,
                    pool=tr.dst.label, slot=lr.slot,
                )
        # retry queued handoffs (window room / slots may have freed); each
        # may target a different worker, so later entries aren't blocked by
        # an earlier one waiting on a different destination
        for tr in list(self.pending_handoff):
            if self._start_transfer(tr, now):
                self.pending_handoff.remove(tr)

        # ---- decode stage ------------------------------------------------
        for w in self.decode_pool:
            if not w.active:
                continue
            srv = w.server
            batch_reqs, _ = srv.decode_sched.select(
                [l.req for l in w.active], srv._now()
            )
            batch = [l for l in w.active if l.req in batch_reqs]
            t0 = clock.monotonic()
            toks = srv.decode.step(batch, srv._gen)
            step_t = (clock.monotonic() - t0) * ecfg.time_scale
            tend = srv._now()
            srv.decode_sched.observe([l.req for l in batch], step_t)
            if trc is not None and batch:
                trc.emit(
                    EventType.DECODE_STEP, tend, pool=w.label,
                    batch=len(batch), step_time=step_t,
                    active=len(w.active),
                    tpot_budget=min(l.req.slo.tpot for l in batch),
                )
            for lr, tok in zip(batch, toks, strict=True):
                r = lr.req
                tok = int(tok)
                lr.tokens.append(tok)
                r.n_generated += 1
                r.n_decoded += 1
                r.token_times.append(tend)
                if trc is not None:
                    trc.emit(
                        EventType.TOKEN, tend, rid=r.rid, tenant=r.tenant,
                        pool=w.label, slot=lr.slot,
                    )
                self._emit(r, tok, tend)
                done = (
                    tok == ecfg.eos_token
                    or r.n_generated >= r.output_len
                    or r.seq_len >= ecfg.max_len - 1
                )
                if done:
                    r.phase = Phase.DONE
                    r.done_time = tend
                    slot = lr.slot
                    srv.decode.release(lr)  # also unpins r.rid's radix hold
                    self._kv_dst.pop(r.rid, None)
                    w.active.remove(lr)
                    self.metrics.completed += 1
                    self.metrics._bump(self.metrics.completed_by_tenant, r.tenant)
                    completed.append(r.rid)
                    if trc is not None:
                        trc.emit(
                            EventType.DONE, tend, rid=r.rid, tenant=r.tenant,
                            pool=w.label, slot=slot, n_generated=r.n_generated,
                        )

        # when the only remaining work is KV on the wire, nudge the clock
        # toward the earliest ready_at — same rule as `ServeSession.step`
        if (
            (self.inflight or self.pending_handoff)
            and not admitted
            and not any(w.queue or w.active for w in (*self.prefill_pool, *self.decode_pool))
        ):
            nxt = min((tr.ready_at for tr in self.inflight), default=now)
            clock.sleep(min(0.001, max(0.0, nxt - self.server._now())))
        return completed

    # ------------------------------------------------------------- metrics
    def handoff_summary(self) -> Dict[str, Any]:
        h = self.handoff
        return dict(
            transfers_started=h.transfers_started,
            transfers_completed=h.transfers_completed,
            transfers_cancelled=h.transfers_cancelled,
            cross_transfers=h.cross_transfers,
            local_transfers=h.local_transfers,
            inflight_cap=self.max_inflight_transfers,
            bytes_transferred=h.bytes_transferred,
            queue_wait_total=h.queue_wait_total,
            queue_wait_max=h.queue_wait_max,
            queued_peak=h.queued_peak,
            inflight_peak=h.inflight_peak,
            by_dst={
                w.label: sum(
                    1 for lbl in self._decode_worker_of.values() if lbl == w.label
                )
                for w in self.decode_pool
            },
        )

    def deflection_summary(self) -> Dict[str, Any]:
        return dict(
            policy=self.deflect.name,
            deflected=self.deflected,
            deflected_rids=list(self.deflected_rids),
            by_dst=dict(self._deflected_by_dst),
        )

    def summary(self) -> Dict[str, Any]:
        """`ServeSession.summary`'s keys (so every downstream consumer of a
        session summary keeps working) plus the fleet blocks: ``pools``,
        ``handoff``, ``deflection``, and per-request pool labels."""
        labels = self.pool_labels()
        per = [
            dict(
                rid=r.rid,
                tenant=r.tenant,
                slo_class=r.slo_class,
                phase=r.phase.value,
                ttft=r.ttft(),
                mean_tpot=r.mean_tpot(),
                meets_e2e=r.meets_e2e() if r.phase == Phase.DONE else False,
                prefill_pool=labels["prefill"].get(r.rid),
                decode_pool=labels["decode"].get(r.rid),
            )
            for r in self.requests
        ]
        m = self.metrics
        return dict(
            submitted=m.submitted,
            accepted=m.accepted,
            rejected=m.rejected,
            rejected_global=m.rejected_global,
            rejected_tenant=m.rejected_tenant,
            completed=m.completed,
            cancelled=m.cancelled,
            backpressure_shed=m.backpressure_shed,
            rejected_rids=list(m.rejected_rids),
            cancelled_rids=list(m.cancelled_rids),
            submitted_by_tenant=dict(m.submitted_by_tenant),
            rejected_by_tenant=dict(m.rejected_by_tenant),
            completed_by_tenant=dict(m.completed_by_tenant),
            cancelled_by_tenant=dict(m.cancelled_by_tenant),
            prefix=dict(
                lookups=m.prefix_lookups,
                hits=m.prefix_hits,
                hit_tokens=m.prefix_hit_tokens,
                lookup_tokens=m.prefix_lookup_tokens,
                hit_rate=(
                    m.prefix_hit_tokens / m.prefix_lookup_tokens
                    if m.prefix_lookup_tokens
                    else 0.0
                ),
            ),
            prefix_cached_tokens=m.prefix_cached_tokens,
            prefill_computed_tokens=m.prefill_computed_tokens,
            pages=self._pages_summary(),
            pools=dict(
                prefill=len(self.prefill_pool), decode=len(self.decode_pool)
            ),
            handoff=self.handoff_summary(),
            deflection=self.deflection_summary(),
            requests=per,
        )

    def _pages_summary(self) -> Optional[Dict[str, Any]]:
        """Decode-pool-wide page accounting (None on non-paged fleets)."""
        if not self.paged:
            return None
        allocs = [w.server.decode for w in self.decode_pool]
        return dict(
            page_size=allocs[0].pages.page_size,
            total=sum(d.pages.n_pages for d in allocs),
            free=sum(d.pages.free_pages for d in allocs),
            used_tokens=sum(d.pages.used_tokens for d in allocs),
            shared_links=sum(d.pages.shared_links for d in allocs),
            pressure_evictions=sum(d.pages.pressure_evictions for d in allocs),
            cached_blocks=sum(len(d.prefix) for d in allocs),
        )


class DisaggFleetSession(AsyncServeSession):
    """Async streaming frontend over a `DisaggSession` core.

    The entire client surface — ``submit -> RequestHandle``, streaming,
    cancellation, ``replay``, ``drain``/``aclose`` — is inherited from
    `AsyncServeSession` via session injection; only construction differs:
    two server pools, a deflection policy, and the transfer window bound.
    """

    def __init__(
        self,
        prefill_servers: Sequence[DisaggServer],
        decode_servers: Sequence[DisaggServer],
        deflection: Union[str, PolicySpec] = "never",
        max_queue_depth: Any = FROM_CONFIG,
        tenant_queue_depth: Any = FROM_CONFIG,
        stream_buffer: int = 16,
        backpressure: str = "block",
        idle_wait: float = 0.001,
        max_inflight_transfers: int = 8,
        trace: Optional[TraceRecorder] = None,
    ):
        core = DisaggSession(
            prefill_servers,
            decode_servers,
            deflection=deflection,
            max_queue_depth=max_queue_depth,
            tenant_queue_depth=tenant_queue_depth,
            max_inflight_transfers=max_inflight_transfers,
            trace=trace,
        )
        super().__init__(
            core.server,  # unused when a session is injected; kept for repr
            stream_buffer=stream_buffer,
            backpressure=backpressure,
            idle_wait=idle_wait,
            session=core,
        )

    @property
    def core(self) -> DisaggSession:
        return self.session
