"""Streaming serve session: the non-blocking face of `DisaggServer` (port
of ``repro.serving.session``; the reference's per-step key split becomes
the server's `torch.Generator`).

``DisaggServer.serve(requests)`` is a thin loop over this class. A `ServeSession` owns the in-flight request state and
exposes the three primitives an online frontend needs:

    submit(request, prompt)   admit (or shed) a request, at any time
    step()                    advance prefill + admission + decode one round
    on_token callbacks        per-request and session-wide streaming hooks
    cancel(rid)               client disconnect: reclaim the request's
                              queue entry / decode slot, Phase.CANCELLED

(`repro_torch.serving.frontend.AsyncServeSession` builds the online
asyncio frontend — streaming handles, backpressure, open-loop replay — on
exactly these primitives.)

Admission control: ``max_queue_depth`` bounds the prefill queue, and
``tenant_queue_depth`` additionally bounds how many queued requests any one
tenant may hold (so a single tenant's burst can't monopolize admission). A
submit that would exceed either bound is *shed* — the request is marked
``Phase.FAILED``, counted in the session metrics (``rejected`` /
``rejected_rids``, plus the ``*_by_tenant`` breakdowns), and ``submit``
returns False. The defaults (``FROM_CONFIG``) inherit
``EngineConfig.admission_queue_depth`` / ``tenant_queue_depth``; pass
``None`` for explicitly unbounded admission regardless of the config (the
config's own defaults are unbounded, which preserves historical ``serve()``
behavior).

``submit`` validates that ``request.input_len == len(prompt)`` and raises
``ValueError`` on mismatch: the declared length feeds the SLO/urgency
arithmetic the caller set up, so silently reassigning it (as the old serve
loop did) desyncs scheduling from the caller's intent.

See DESIGN.md §session.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.request import Phase, Request
from repro_torch.obs.events import EventType, TraceRecorder
from repro_torch.serving.engine import DisaggServer, LiveRequest
from repro_torch.serving.prefixcache import PrefixCache

# on_token(request, token, t_virtual) — called as each token is produced.
TokenCallback = Callable[[Request, int, float], None]

# Sentinel: inherit EngineConfig.admission_queue_depth. Distinct from None,
# which always means unbounded — so a caller can request an unbounded
# session over a server whose config sets a depth.
FROM_CONFIG: Any = object()


@dataclass
class SessionMetrics:
    """Counters for one session's lifetime (shedding included), with a
    per-tenant breakdown so multi-tenant quota decisions stay auditable."""

    submitted: int = 0
    accepted: int = 0
    # shed by admission control — always rejected_global + rejected_tenant
    # (kept as its own counter for schema compatibility); the split tells a
    # per-tenant shed report "fleet full" apart from "quota hit"
    rejected: int = 0
    rejected_global: int = 0  # global queue bound (max_queue_depth) hit
    rejected_tenant: int = 0  # per-tenant quota (tenant_queue_depth) hit
    completed: int = 0
    cancelled: int = 0  # withdrawn by the client (disconnect / cancel())
    # cancellations forced by the async frontend's backpressure policy when a
    # slow consumer's buffer overflows ("shed" policy); a subset of `cancelled`
    backpressure_shed: int = 0
    rejected_rids: List[int] = field(default_factory=list)
    cancelled_rids: List[int] = field(default_factory=list)
    submitted_by_tenant: Dict[str, int] = field(default_factory=dict)
    rejected_by_tenant: Dict[str, int] = field(default_factory=dict)
    completed_by_tenant: Dict[str, int] = field(default_factory=dict)
    cancelled_by_tenant: Dict[str, int] = field(default_factory=dict)
    # prefix-cache admission accounting (zero unless the session was built
    # with a PrefixCache); hit tokens are also granted to the SlotAllocator
    # as a KV budget credit — see serving/prefixcache.py
    prefix_lookups: int = 0
    prefix_hits: int = 0
    prefix_hit_tokens: int = 0
    prefix_lookup_tokens: int = 0
    # paged engines only: hit tokens whose KV was *linked* (prefill skipped
    # them entirely) — always <= prefix_hit_tokens, equal on paged sessions
    prefix_cached_tokens: int = 0
    # prompt tokens the prefill engine actually computed; on a paged session
    # this undershoots the admitted prompt mass by exactly the cached tokens
    # (the "reuse is real" invariant, pinned in tests/test_paged_kv.py)
    prefill_computed_tokens: int = 0

    def _bump(self, table: Dict[str, int], tenant: str) -> None:
        table[tenant] = table.get(tenant, 0) + 1


class ServeSession:
    """Incremental serving over a `DisaggServer`'s engines.

    The session never blocks: ``step()`` runs at most one prefill
    scheduling round, one admission sweep, and one decode step, then
    returns the rids that completed. Interleave ``submit``/``step`` freely
    — that is the whole point.
    """

    def __init__(
        self,
        server: DisaggServer,
        max_queue_depth: Optional[int] = FROM_CONFIG,
        on_token: Optional[TokenCallback] = None,
        tenant_queue_depth: Optional[int] = FROM_CONFIG,
        prefix_cache: Optional["PrefixCache"] = None,
        trace: Optional[TraceRecorder] = None,
        trace_label: str = "engine:0",
    ):
        self.server = server
        # observability (repro_torch.obs): None = tracing off, the default — the
        # disabled path is a single `is not None` test per emission point.
        # Emissions only ever reuse timestamps this session already read
        # from the injected clock, so enabling a recorder cannot perturb
        # ManualClock schedules (pinned in tests/test_obs.py).
        self.trace = trace if trace is not None else getattr(server, "trace", None)
        self.trace_label = trace_label
        self.ecfg = server.ecfg
        if max_queue_depth is FROM_CONFIG:
            max_queue_depth = server.ecfg.admission_queue_depth
        self.max_queue_depth = max_queue_depth  # None = unbounded
        if tenant_queue_depth is FROM_CONFIG:
            tenant_queue_depth = server.ecfg.tenant_queue_depth
        self.tenant_queue_depth = tenant_queue_depth  # None = no per-tenant quota
        # prefix-cache-aware admission: every admitted prompt is matched then
        # inserted; matched tokens become the request's prefix_hit_tokens
        # (KV budget credit + hit metrics). None = no prefix awareness. On a
        # paged engine the cache is the engine-owned page-mapped radix trie
        # — hits link live KV pages and skip real compute, so any
        # accounting-only cache the caller passed is superseded.
        if server.decode.paged:
            prefix_cache = server.decode.prefix
        self.prefix_cache = prefix_cache
        self.on_token = on_token

        self.queue: List[LiveRequest] = []  # waiting for / in chunked prefill
        self.waiting_adm: List[LiveRequest] = []  # KV transfer -> decode slot
        self.active: List[LiveRequest] = []  # decoding
        self.outputs: Dict[int, List[int]] = {}
        self.requests: List[Request] = []  # every submitted request, shed too
        self.metrics = SessionMetrics()
        self._callbacks: Dict[int, TokenCallback] = {}

    # ------------------------------------------------------------- submit
    def submit(
        self,
        request: Request,
        prompt: Sequence[int],
        on_token: Optional[TokenCallback] = None,
    ) -> bool:
        """Admit a request; returns False (and sheds it) when the prefill
        queue is at ``max_queue_depth`` or the request's tenant already has
        ``tenant_queue_depth`` requests queued. Raises ValueError if the
        declared ``input_len`` does not match the prompt."""
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
            # t = declared arrival: submission never reads the clock, and an
            # emission must not either (ManualClock.auto_step advances per
            # monotonic() read — a new read here would shift every schedule)
            tr.emit(
                EventType.SUBMIT, request.arrival, rid=request.rid,
                tenant=request.tenant, pool=self.trace_label,
                arrival=request.arrival, input_len=request.input_len,
                output_len=request.output_len, slo_ttft=request.slo.ttft,
                slo_tpot=request.slo.tpot, slo_class=request.slo_class,
            )
        shed_global = (
            self.max_queue_depth is not None and len(self.queue) >= self.max_queue_depth
        )
        shed_tenant = False
        if not shed_global and self.tenant_queue_depth is not None:
            queued = sum(1 for lr in self.queue if lr.req.tenant == request.tenant)
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
                    tenant=request.tenant, pool=self.trace_label,
                    scope="global" if shed_global else "tenant",
                    queue_depth=len(self.queue),
                )
            return False
        m.accepted += 1
        lr = LiveRequest(req=request, tokens=list(prompt))
        prefix_kw: Dict[str, int] = {}
        if self.prefix_cache is not None:
            # admitted prompts only enter the trie: a shed prompt's KV never
            # materializes, so indexing it would advertise phantom reuse.
            # The rid pins the prompt's node path against eviction until the
            # request leaves the system (release in step()/cancel()).
            hit, eligible = self.prefix_cache.admit(prompt, rid=request.rid)
            request.prefix_hit_tokens = hit
            if self.server.decode.paged:
                # real reuse: prefill starts after the cached head, and the
                # matched pages are linked into the page table at reserve
                request.prefix_cached_tokens = hit
                m.prefix_cached_tokens += hit
                lr.shared_pages = self.prefix_cache.shared_pages(request.rid)
                lr.kv_src = self.server.decode
            m.prefix_lookups += 1
            m.prefix_lookup_tokens += eligible
            m.prefix_hit_tokens += hit
            if hit:
                m.prefix_hits += 1
            prefix_kw = dict(prefix_eligible=eligible, prefix_hit=hit)
        self.queue.append(lr)
        if tr is not None:
            tr.emit(
                EventType.ADMIT, request.arrival, rid=request.rid,
                tenant=request.tenant, pool=self.trace_label,
                queue_depth=len(self.queue), **prefix_kw,
            )
        if on_token is not None:
            self._callbacks[request.rid] = on_token
        return True

    # -------------------------------------------------------------- cancel
    def cancel(self, rid: int) -> bool:
        """Withdraw an in-flight request (client disconnect).

        Wherever the request currently lives — prefill queue, KV-transfer
        wait, or an active decode slot — it is removed, its decode slot and
        prefill cache are reclaimed immediately, and it terminates in
        ``Phase.CANCELLED`` (NOT ``FAILED``: cancellation is the client
        walking away, not an admission-control SLO miss, and the metrics
        keep the two apart). Returns False if ``rid`` is not in flight
        (already terminal, shed, or unknown) — cancelling twice is a no-op.
        """
        stages = ("queue", "transfer", "decode")
        for lst, stage in zip((self.queue, self.waiting_adm, self.active), stages, strict=True):
            for lr in lst:
                if lr.req.rid == rid:
                    lst.remove(lr)
                    slot = lr.slot
                    self.server.decode.release(lr)
                    if self.prefix_cache is not None:
                        self.prefix_cache.release(rid)  # idempotent unpin
                    lr.prefill_cache = None
                    lr.req.phase = Phase.CANCELLED
                    lr.req.done_time = self.server._now()
                    self._callbacks.pop(rid, None)
                    m = self.metrics
                    m.cancelled += 1
                    m.cancelled_rids.append(rid)
                    m._bump(m.cancelled_by_tenant, lr.req.tenant)
                    if self.trace is not None:
                        self.trace.emit(
                            EventType.CANCEL, lr.req.done_time, rid=rid,
                            tenant=lr.req.tenant, pool=self.trace_label,
                            slot=slot, stage=stage,
                        )
                    return True
        return False

    # -------------------------------------------------------------- state
    @property
    def has_work(self) -> bool:
        return bool(self.queue or self.waiting_adm or self.active)

    def _emit(self, req: Request, tok: int, t: float) -> None:
        self.outputs.setdefault(req.rid, []).append(tok)
        cb = self._callbacks.get(req.rid)
        if cb is not None:
            cb(req, tok, t)
        if self.on_token is not None:
            self.on_token(req, tok, t)

    # ---------------------------------------------------------------- step
    def step(self) -> List[int]:
        """Advance the session one round; returns rids completed this round."""
        srv = self.server
        ecfg = self.ecfg
        clock = srv.clock
        completed: List[int] = []
        now = srv._now()

        # ---- prefill side ------------------------------------------------
        tr = self.trace
        pq = [lr.req for lr in self.queue]
        if pq:
            sel = srv.prefill_sched.select(pq, now, srv.mu.mu, ecfg.chunk_size)
            t0 = clock.monotonic()
            total = 0
            for req, take in sel:
                lr = next(l for l in self.queue if l.req is req)
                if tr is not None and req.prefilled_tokens == 0:
                    # first chunk of this request's prefill (t = the round's
                    # already-read `now`; no extra clock read)
                    tr.emit(
                        EventType.PREFILL_START, now, rid=req.rid,
                        tenant=req.tenant, pool=self.trace_label, take=take,
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
                    # price the PD handoff with the simulator's formula: the
                    # KV is admissible only after lat + bytes/bw has elapsed.
                    # Cached-prefix tokens never cross the wire (their pages
                    # are already in the decode pool), so only the computed
                    # tail is priced; prefix_cached_tokens is 0 off-paged
                    lr.transfer_ready_at = fin + srv.cost.transfer_time(
                        req.input_len - req.prefix_cached_tokens
                    )
                    self.queue.remove(lr)
                    self.waiting_adm.append(lr)
                    if tr is not None:
                        lbl = self.trace_label
                        tr.emit(
                            EventType.PREFILL_END, fin, rid=req.rid,
                            tenant=req.tenant, pool=lbl,
                            queue_depth=len(self.queue),
                        )
                        # single-server handoff: the KV goes on the wire the
                        # moment prefill finishes (no bounded in-flight
                        # window), so QUEUED and START coincide at `fin`
                        tr.emit(
                            EventType.HANDOFF_QUEUED, fin, rid=req.rid,
                            tenant=req.tenant, pool=lbl,
                        )
                        tr.emit(
                            EventType.HANDOFF_START, fin, rid=req.rid,
                            tenant=req.tenant, pool=lbl,
                            ready_at=lr.transfer_ready_at,
                        )
                        tr.emit(
                            EventType.TOKEN, fin, rid=req.rid,
                            tenant=req.tenant, pool=lbl,
                        )
                    self._emit(req, tok, fin)
            elapsed = (clock.monotonic() - t0) * ecfg.time_scale
            self.metrics.prefill_computed_tokens += total
            if total:
                srv.mu.update(total, max(elapsed, 1e-9))

        # ---- admission (KV transfer) ------------------------------------
        admitted = False
        for lr in list(self.waiting_adm):
            if lr.transfer_ready_at is not None and now < lr.transfer_ready_at:
                continue  # KV still on the wire
            if srv.decode.admit(lr):
                lr.req.phase = Phase.DECODE
                lr.req.decode_start = srv._now()
                self.waiting_adm.remove(lr)
                self.active.append(lr)
                admitted = True
                if tr is not None:
                    tr.emit(
                        EventType.HANDOFF_ATTACH, lr.req.decode_start,
                        rid=lr.req.rid, tenant=lr.req.tenant,
                        pool=self.trace_label, slot=lr.slot,
                    )

        # ---- decode side -------------------------------------------------
        if self.active:
            batch_reqs, _ = srv.decode_sched.select(
                [l.req for l in self.active], srv._now()
            )
            batch = [l for l in self.active if l.req in batch_reqs]
            t0 = clock.monotonic()
            toks = srv.decode.step(batch, srv._gen)
            step_t = (clock.monotonic() - t0) * ecfg.time_scale
            tend = srv._now()
            srv.decode_sched.observe([l.req for l in batch], step_t)
            if tr is not None and batch:
                # pool-level step record (rid = -1): the batch the decode
                # scheduler packed, the engine step time, and the tightest
                # TPOT budget in the batch — obs/slo.py's budget series
                tr.emit(
                    EventType.DECODE_STEP, tend, pool=self.trace_label,
                    batch=len(batch), step_time=step_t,
                    active=len(self.active),
                    tpot_budget=min(l.req.slo.tpot for l in batch),
                )
            for lr, tok in zip(batch, toks, strict=True):
                r = lr.req
                tok = int(tok)
                lr.tokens.append(tok)
                r.n_generated += 1
                r.n_decoded += 1
                r.token_times.append(tend)
                if tr is not None:
                    tr.emit(
                        EventType.TOKEN, tend, rid=r.rid, tenant=r.tenant,
                        pool=self.trace_label, slot=lr.slot,
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
                    srv.decode.release(lr)
                    if self.prefix_cache is not None:
                        self.prefix_cache.release(r.rid)  # idempotent unpin
                    self.active.remove(lr)
                    self.metrics.completed += 1
                    self.metrics._bump(self.metrics.completed_by_tenant, r.tenant)
                    completed.append(r.rid)
                    if tr is not None:
                        tr.emit(
                            EventType.DONE, tend, rid=r.rid, tenant=r.tenant,
                            pool=self.trace_label, slot=slot,
                            n_generated=r.n_generated,
                        )

        # when the only remaining work is KV on the wire, nudge the clock
        # toward the earliest transfer_ready_at so runs on a virtual clock
        # (ManualClock) make progress instead of spinning at `now`
        if self.waiting_adm and not admitted and not self.queue and not self.active:
            nxt = min((lr.transfer_ready_at or 0.0) for lr in self.waiting_adm)
            clock.sleep(min(0.001, max(0.0, nxt - srv._now())))
        return completed

    # ----------------------------------------------------------------- run
    def run(self, requests: Sequence) -> Dict[int, List[int]]:
        """Offline run — the one canonical submit-when-arrived/step loop.

        Submits each (Request, prompt_tokens) pair once its ``arrival``
        (virtual seconds) passes, steps until drained, returns rid ->
        output tokens. ``DisaggServer.serve()`` and the CLI entry points
        all call this rather than re-implementing the loop.
        """
        srv = self.server
        srv.reset_clock()
        pending = sorted(requests, key=lambda x: x[0].arrival)
        while pending or self.has_work:
            now = srv._now()
            while pending and pending[0][0].arrival <= now:
                req, prompt = pending.pop(0)
                self.submit(req, prompt)
            if self.has_work:
                self.step()
            elif pending:
                srv.clock.sleep(
                    min(0.001, max(0.0, pending[0][0].arrival - srv._now()))
                )
        return self.outputs

    # ------------------------------------------------------------- metrics
    def summary(self) -> Dict[str, Any]:
        """Session counters + per-request TTFT/TPOT (shed requests included,
        with null latency metrics)."""
        per = [
            dict(
                rid=r.rid,
                tenant=r.tenant,
                slo_class=r.slo_class,
                phase=r.phase.value,
                ttft=r.ttft(),
                mean_tpot=r.mean_tpot(),
                meets_e2e=r.meets_e2e() if r.phase == Phase.DONE else False,
            )
            for r in self.requests
        ]
        m = self.metrics
        decode = self.server.decode
        pages = None
        if decode.paged:
            pa = decode.pages
            pages = dict(
                page_size=pa.page_size,
                total=pa.n_pages,
                free=pa.free_pages,
                used_tokens=pa.used_tokens,
                shared_links=pa.shared_links,
                pressure_evictions=pa.pressure_evictions,
                cached_blocks=len(decode.prefix),
            )
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
            pages=pages,
            requests=per,
        )
