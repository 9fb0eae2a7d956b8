"""Async streaming frontend: the online face of `ServeSession` (port of
``repro.serving.frontend``).

`ServeSession` (repro_torch.serving.session) is deliberately synchronous — submit,
step, callbacks. This module puts an asyncio event loop on top of it so the
engine can serve *live* clients the way the paper's testbed does: admission
and token delivery happen concurrently with scheduling, not as a replayed
trace.

    frontend = AsyncServeSession(server)
    async with frontend:
        handle = await frontend.submit(request, prompt)
        async for token in handle.stream():
            ...                      # tokens arrive as the engine produces them

Architecture (DESIGN.md §frontend):

  * One background **stepper** task owns every interaction with the engine
    clock and the underlying `ServeSession`. Per iteration it ingests client
    intents (submit/cancel), reads virtual time ONCE, admits scheduled
    submissions whose arrival has passed, runs `session.step()`, then
    delivers the step's tokens into per-request buffers. The loop body
    mirrors `ServeSession.run()` read-for-read, so on a `ManualClock` the
    async frontend reproduces the sync session's TTFT/TPOT *bit-for-bit*
    (tested in tests/test_torch_frontend.py, and against the JAX
    package's frontend there).
  * Each request gets a `RequestHandle` with a **bounded token buffer**
    (``stream_buffer`` tokens, +1 slot reserved for the end-of-stream
    marker). When a consumer is too slow, the ``backpressure`` policy
    decides: ``"block"`` stalls the stepper until the consumer drains
    (classic backpressure — the whole engine waits), ``"shed"`` cancels the
    slow consumer's request, reclaims its slots, and records it in
    `SessionMetrics.backpressure_shed`.
  * **Cancellation**: abandoning ``handle.stream()`` (client disconnect) or
    calling ``handle.cancel()`` queues a cancel intent; the stepper calls
    `ServeSession.cancel`, which removes the request from whichever stage
    holds it, frees its decode slot / prefill cache, and terminates it in
    `Phase.CANCELLED` — distinct from admission shedding (`FAILED`).
  * **Drain/close**: ``drain()`` waits for all admitted work to finish, then
    stops the stepper; ``aclose()`` cancels everything in flight first.
    ``async with`` drains on clean exit and cancels on exception.

Timing rule: the stepper is the only code that touches ``server.clock`` —
client coroutines never read it, which is what keeps `ManualClock` runs
deterministic under arbitrary task interleavings.
"""
from __future__ import annotations

import asyncio
import heapq
from typing import Any, AsyncIterator, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.request import TERMINAL_PHASES, Phase, Request
from repro_torch.obs.events import EventType
from repro_torch.serving.engine import DisaggServer
from repro_torch.serving.session import FROM_CONFIG, ServeSession, SessionMetrics

BACKPRESSURE_POLICIES: Tuple[str, ...] = ("block", "shed")

_EOS = object()  # end-of-stream marker inside handle buffers


async def drive_replay(
    submit: Any,
    pairs: Sequence[Tuple[Request, Sequence[int]]],
    clients: int = 4,
    on_client_token: Optional[Any] = None,
) -> None:
    """The one open-loop replay drive, shared by `AsyncServeSession.replay`
    and `RouterSession.replay` (one body, so their await sequences cannot
    drift — the bit-parity contracts depend on that): submit each pair at
    its arrival in stable order via ``submit(request, prompt, at=...)``,
    then drain every handle with ``clients`` concurrent consumer tasks."""
    order = sorted(range(len(pairs)), key=lambda i: pairs[i][0].arrival)
    handles = []
    for i in order:
        req, prompt = pairs[i]
        handles.append(await submit(req, prompt, at=req.arrival))

    async def consume(c: int) -> None:
        async def drain_one(h: "RequestHandle") -> None:
            async for tok in h.stream():
                if on_client_token is not None:
                    on_client_token(c, tok)

        await asyncio.gather(*(drain_one(h) for h in handles[c::clients]))

    clients = max(1, clients)
    await asyncio.gather(*(consume(c) for c in range(clients)))


class RequestHandle:
    """A client's view of one submitted request.

    ``await handle.admitted()`` resolves once admission control has run
    (False = shed). ``async for tok in handle.stream()`` yields tokens as
    the engine produces them; exiting the iteration early (break, task
    cancellation, client disconnect) cancels the request. ``cancel_reason``
    is ``None``, ``"client"``, or ``"backpressure"``.
    """

    def __init__(self, frontend: "AsyncServeSession", request: Request, buffer: int):
        self._frontend = frontend
        self.request = request
        # +2 reserved slots past the advertised buffer: a request that
        # *completes* while its buffer is full still owes the client one
        # final token plus the EOS marker, and neither may be dropped (the
        # shed policy only aborts requests that would keep producing)
        self._queue: asyncio.Queue = asyncio.Queue(maxsize=buffer + 2)
        self._admit_event = asyncio.Event()
        self._accepted: Optional[bool] = None
        self._closed = False  # EOS enqueued; no more tokens will arrive
        self.cancel_reason: Optional[str] = None

    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def tokens(self) -> List[int]:
        """Tokens produced so far (including any not yet consumed)."""
        return list(self._frontend.session.outputs.get(self.rid, []))

    async def admitted(self) -> bool:
        await self._admit_event.wait()
        return bool(self._accepted)

    async def stream(self) -> AsyncIterator[int]:
        """Yield tokens in generation order until the request finishes.

        A shed request yields nothing. Leaving the loop before the stream
        is exhausted counts as a client disconnect: the request is
        cancelled and its engine resources reclaimed.
        """
        if not await self.admitted():
            return
        try:
            while True:
                item = await self._queue.get()
                if item is _EOS:
                    break
                yield item
        finally:
            self.cancel()  # no-op once the request is terminal

    async def result(self) -> List[int]:
        """Drain the stream and return the full output token list."""
        async for _ in self.stream():
            pass
        return self.tokens

    def cancel(self) -> None:
        """Withdraw the request (idempotent; no-op after DONE/FAILED)."""
        if self.request.phase in TERMINAL_PHASES:
            return
        # Discard the unread backlog first: under the "block" policy the
        # stepper may be parked in `queue.put` on OUR full buffer, and the
        # cancel intent can only be processed once that put resolves —
        # get_nowait wakes the pending putter, breaking the deadlock.
        while not self._queue.empty():
            try:
                self._queue.get_nowait()
            except asyncio.QueueEmpty:  # pragma: no cover - single-threaded
                break
        self._frontend._request_cancel(self.rid)

    # ---- frontend-side plumbing (called only from the stepper task) ------
    def _resolve_admission(self, accepted: bool) -> None:
        self._accepted = accepted
        self._admit_event.set()
        if not accepted:
            self._close_now()

    def _close_now(self) -> None:
        """Terminate the stream, discarding buffered-but-unread tokens.

        Used for shed/cancelled streams where the client no longer wants
        the backlog; normal completion enqueues EOS behind the tokens
        instead (`AsyncServeSession._finish`).
        """
        if self._closed:
            return
        self._closed = True
        while not self._queue.empty():
            self._queue.get_nowait()
        self._queue.put_nowait(_EOS)


class _Intent:
    """A submit waiting for the stepper (``at`` = virtual arrival time)."""

    __slots__ = ("at", "seq", "request", "prompt", "handle", "cancelled")

    def __init__(self, at: float, seq: int, request: Request, prompt: List[int],
                 handle: RequestHandle):
        self.at, self.seq = at, seq
        self.request, self.prompt, self.handle = request, prompt, handle
        self.cancelled = False

    def __lt__(self, other: "_Intent") -> bool:  # heap order: arrival, FIFO
        return (self.at, self.seq) < (other.at, other.seq)


class AsyncServeSession:
    """Asyncio frontend over a `ServeSession` (see module docstring).

    Parameters mirror `ServeSession` (admission bounds inherit the server's
    `EngineConfig` via ``FROM_CONFIG``), plus the streaming knobs:

    stream_buffer   per-request token buffer (tokens a consumer may lag)
    backpressure    "block" (stall the engine for slow consumers) or
                    "shed" (cancel the slow consumer's request)
    idle_wait       max virtual seconds advanced per idle iteration while
                    waiting on a scheduled arrival; 0.001 matches
                    `ServeSession.run` exactly (keep it for parity)
    """

    def __init__(
        self,
        server: DisaggServer,
        max_queue_depth: Any = FROM_CONFIG,
        tenant_queue_depth: Any = FROM_CONFIG,
        stream_buffer: int = 16,
        backpressure: str = "block",
        idle_wait: float = 0.001,
        prefix_cache: Optional[Any] = None,
        session: Optional[Any] = None,
        trace: Optional[Any] = None,
        trace_label: str = "engine:0",
    ):
        if backpressure not in BACKPRESSURE_POLICIES:
            raise ValueError(
                f"backpressure={backpressure!r}; expected one of {BACKPRESSURE_POLICIES}"
            )
        if stream_buffer < 1:
            raise ValueError("stream_buffer must be >= 1")
        if session is not None:
            # session injection: a pre-built ServeSession-shaped core (e.g.
            # repro_torch.serving.disagg.DisaggSession) keeps this frontend's whole
            # submit/stream/cancel/replay machinery; the core only needs the
            # duck type (server/submit/step/cancel/outputs/metrics/on_token)
            session.on_token = self._collect_token
            self.session = session
        else:
            self.session = ServeSession(
                server,
                max_queue_depth=max_queue_depth,
                tenant_queue_depth=tenant_queue_depth,
                on_token=self._collect_token,
                prefix_cache=prefix_cache,
                trace=trace,
                trace_label=trace_label,
            )
        self.stream_buffer = stream_buffer
        self.backpressure = backpressure
        self.idle_wait = idle_wait
        # ManualClock-style clocks expose advance(); their sleep() returns
        # instantly, so the stepper may call it inline. A wall clock must be
        # awaited instead or it would block the entire event loop.
        self._virtual_clock = hasattr(self.session.server.clock, "advance")

        self._handles: Dict[int, RequestHandle] = {}  # admitted, streaming
        self._scheduled: List[_Intent] = []  # heap: (arrival, seq)
        self._submit_intents: List[_Intent] = []
        self._cancel_intents: List[int] = []
        self._emitted: List[Tuple[Request, int, float]] = []  # tokens of the current step
        self._seq = 0
        self._wake = asyncio.Event()
        self._drained = asyncio.Event()
        self._draining = False
        self._stepper: Optional[asyncio.Task] = None

    # ------------------------------------------------------------- metrics
    @property
    def metrics(self) -> SessionMetrics:
        return self.session.metrics

    def summary(self) -> Dict[str, Any]:
        return self.session.summary()

    # ------------------------------------------------------------ lifecycle
    async def __aenter__(self) -> "AsyncServeSession":
        self.start()
        return self

    async def __aexit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            await self.drain()
        else:
            await self.aclose()

    def start(self) -> None:
        """Re-zero virtual time and launch the background stepper task.

        Restart after a completed ``drain()`` is supported: the drain state
        is reset so the new stepper doesn't inherit a set ``_drained`` event
        and exit at its first idle moment.
        """
        if self._stepper is not None:
            raise RuntimeError("frontend already started")
        self._draining = False
        self._drained = asyncio.Event()
        self.session.server.reset_clock()
        self._stepper = asyncio.get_running_loop().create_task(
            self._run_stepper(), name="serve-stepper"
        )

    async def drain(self) -> None:
        """Wait for every admitted request to reach a terminal phase, then
        stop the stepper. Streams stay consumable afterwards (their EOS is
        already buffered). Re-raises the stepper's exception if the engine
        crashed mid-run."""
        if self._stepper is None:
            return
        self._draining = True
        self._wake.set()
        await self._drained.wait()
        stepper, self._stepper = self._stepper, None
        if stepper is not None:  # kill() mid-drain leaves nothing to await
            await stepper  # surfaces a stepper crash as a traceback

    async def aclose(self) -> None:
        """Hard stop: cancel the stepper and every in-flight request —
        including submits the stepper never got to ingest, whose handles
        must still resolve or their awaiters would hang forever."""
        if self._stepper is not None:
            self._stepper.cancel()
            try:
                await self._stepper
            except asyncio.CancelledError:
                pass
            except BaseException:
                # hard stop: the caller is already on an error path (or wants
                # teardown regardless); drain() is the error-surfacing API
                pass
            self._stepper = None
        for intent in self._submit_intents + self._scheduled:
            self._cancel_unadmitted(intent)
        self._submit_intents.clear()
        self._scheduled.clear()
        for rid, h in list(self._handles.items()):
            if self.session.cancel(rid):
                h.cancel_reason = h.cancel_reason or "client"
            h._close_now()
        self._handles.clear()

    async def kill(self) -> None:
        """Fault injection: this replica dies mid-step.

        Unlike `aclose` it emits NO terminal events and closes NO streams —
        a dead process doesn't get to say goodbye. Every piece of frontend
        and session state (scheduled intents, live handles, queue/active
        sets, the allocator) is left exactly where the crash found it, so a
        fleet controller can harvest the in-flight work and restore it onto
        survivors (`repro_torch.serving.fleetctl.FleetSession.kill_replica`),
        which is also responsible for clearing the carcass afterwards —
        otherwise those handles would double-terminate at teardown.
        """
        if self._stepper is None:
            return
        self._stepper.cancel()
        try:
            await self._stepper
        except asyncio.CancelledError:
            pass
        except BaseException:
            pass  # a crash mid-kill is still a dead replica
        self._stepper = None
        # a drain() racing the kill must not wait forever on a stepper that
        # will never set the event; it finds _stepper already None above
        self._drained.set()

    def _cancel_unadmitted(self, intent: "_Intent") -> None:
        """Withdraw a request admission control never saw: it still ends in
        Phase.CANCELLED and still counts in the session metrics, or a
        pre-admission disconnect would vanish from every report. It is
        recorded as submitted-but-neither-accepted-nor-rejected, with a
        per-request row in ``summary()`` like every other terminal fate."""
        if intent.cancelled or intent.handle._accepted is not None:
            return
        intent.cancelled = True
        req = intent.request
        if req.phase not in TERMINAL_PHASES:
            req.phase = Phase.CANCELLED
            m = self.session.metrics
            m.submitted += 1
            m._bump(m.submitted_by_tenant, req.tenant)
            m.cancelled += 1
            m.cancelled_rids.append(req.rid)
            m._bump(m.cancelled_by_tenant, req.tenant)
            self.session.requests.append(req)
            tr = getattr(self.session, "trace", None)
            if tr is not None:
                # this path bypasses session.submit/cancel, so it must emit
                # the same SUBMIT + CANCEL pair itself or the event-derived
                # counters would diverge from SessionMetrics (pre-admission
                # cancels count as submitted+cancelled). No clock read: the
                # declared arrival timestamps both, like session.submit.
                lbl = getattr(self.session, "trace_label", "")
                tr.emit(
                    EventType.SUBMIT, req.arrival, rid=req.rid,
                    tenant=req.tenant, pool=lbl, arrival=req.arrival,
                    input_len=req.input_len, output_len=req.output_len,
                    slo_ttft=req.slo.ttft, slo_tpot=req.slo.tpot,
                    slo_class=req.slo_class,
                )
                tr.emit(
                    EventType.CANCEL, req.arrival, rid=req.rid,
                    tenant=req.tenant, pool=lbl, stage="pre-admission",
                )
        intent.handle.cancel_reason = "client"
        intent.handle._resolve_admission(False)

    # -------------------------------------------------------------- submit
    async def submit(
        self, request: Request, prompt: Sequence[int], at: Optional[float] = None
    ) -> RequestHandle:
        """Queue a request for admission and return its handle immediately.

        ``at`` schedules the submission at a virtual time (open-loop replay:
        pass ``request.arrival``); ``None`` submits on the stepper's next
        iteration. Admission control runs on the stepper — await
        ``handle.admitted()`` for the shed/accept verdict.
        """
        if self._stepper is None:
            raise RuntimeError("frontend not started (use `async with` or start())")
        if request.input_len != len(prompt):
            raise ValueError(
                f"request rid={request.rid} declares input_len={request.input_len} "
                f"but prompt has {len(prompt)} tokens; the SLO/urgency arithmetic "
                f"is computed from input_len, so they must agree"
            )
        handle = RequestHandle(self, request, self.stream_buffer)
        intent = _Intent(
            float("-inf") if at is None else at, self._seq, request, list(prompt), handle
        )
        self._seq += 1
        self._submit_intents.append(intent)
        self._wake.set()
        return handle

    def _request_cancel(self, rid: int) -> None:
        self._cancel_intents.append(rid)
        self._wake.set()

    # ------------------------------------------------------------- replay
    async def replay(
        self,
        pairs: Sequence[Tuple[Request, Sequence[int]]],
        clients: int = 4,
        on_client_token: Optional[Any] = None,
    ) -> Dict[int, List[int]]:
        """Open-loop replay of (Request, prompt) pairs against the live loop.

        Submissions are scheduled at each request's ``arrival`` in stable
        arrival order (open loop: a slow request never delays the next
        submission), and the resulting streams are drained by ``clients``
        concurrent consumer tasks — handles round-robin across clients,
        every stream drained by its own task so one stalled stream never
        blocks a client's others. ``on_client_token(client_idx, token)``
        is called for each consumed token (loadgen uses it for per-client
        accounting). Returns rid -> output tokens — the same mapping
        `ServeSession.run` returns, and (on a `ManualClock`) with identical
        per-token timestamps.
        """
        await drive_replay(self.submit, pairs, clients, on_client_token)
        return {rid: list(toks) for rid, toks in self.session.outputs.items()}

    # ------------------------------------------------------------- stepper
    def _collect_token(self, req: Request, tok: int, t: float) -> None:
        # sync callback out of session.step(); delivery (which may need to
        # await buffer space) happens right after the step returns
        self._emitted.append((req, tok, t))

    def _process_cancels(self) -> None:
        intents, self._cancel_intents = self._cancel_intents, []
        for rid in intents:
            h = self._handles.pop(rid, None)
            if h is not None:
                if self.session.cancel(rid):
                    h.cancel_reason = h.cancel_reason or "client"
                h._close_now()
                continue
            for intent in self._scheduled:  # not yet admitted
                if intent.request.rid == rid:
                    self._cancel_unadmitted(intent)

    def _ingest_submits(self) -> None:
        intents, self._submit_intents = self._submit_intents, []
        for intent in intents:
            heapq.heappush(self._scheduled, intent)

    def _admit(self, intent: _Intent) -> None:
        if intent.cancelled:
            return
        accepted = self.session.submit(intent.request, intent.prompt)
        if accepted:
            self._handles[intent.request.rid] = intent.handle
        intent.handle._resolve_admission(accepted)

    async def _deliver(self, req: Request, tok: int) -> None:
        h = self._handles.get(req.rid)
        if h is None or h._closed:
            return
        if self.backpressure == "block":
            await h._queue.put(tok)  # stalls the stepper: true backpressure
            return
        # "shed" only aborts requests that would keep producing: a request
        # that just went terminal (this is its final token) delivers into
        # the reserved slots instead — a completed request must never lose
        # tokens to the laggard policy
        if req.phase not in TERMINAL_PHASES and h._queue.qsize() >= self.stream_buffer:
            self._handles.pop(req.rid, None)
            if self.session.cancel(req.rid):
                self.session.metrics.backpressure_shed += 1
            h.cancel_reason = "backpressure"
            h._close_now()
            return
        h._queue.put_nowait(tok)

    async def _finish(self, rid: int) -> None:
        h = self._handles.pop(rid, None)
        if h is None or h._closed:
            return
        h._closed = True
        # the reserved +1 slot guarantees space under "shed"; under "block"
        # a full buffer legitimately waits for the consumer
        if self.backpressure == "block":
            await h._queue.put(_EOS)
        else:
            h._queue.put_nowait(_EOS)

    async def _idle(self, dt: float) -> None:
        if self._virtual_clock:
            # repro: allow[RPA003] ManualClock.sleep only advances virtual time
            self.session.server.clock.sleep(dt)  # returns instantly, never blocks
            await asyncio.sleep(0)  # let clients run at the new time
        else:
            await asyncio.sleep(dt)

    async def _run_stepper(self) -> None:
        """The engine-driving loop, with crash containment: an exception
        escaping the engine must unblock every awaiter (streams get their
        EOS, unresolved admissions resolve False, drain() returns) and then
        re-raise so ``drain()``/``aclose()`` surface a traceback instead of
        the whole frontend hanging silently."""
        try:
            await self._step_loop()
        except asyncio.CancelledError:
            raise  # aclose() tears down explicitly
        except BaseException:
            for intent in self._submit_intents + self._scheduled:
                if intent.handle._accepted is None:
                    intent.cancelled = True
                    intent.handle.cancel_reason = intent.handle.cancel_reason or "error"
                    intent.handle._resolve_admission(False)
            self._submit_intents.clear()
            self._scheduled.clear()
            tr = getattr(self.session, "trace", None)
            lbl = getattr(self.session, "trace_label", "")
            for h in self._handles.values():
                h.cancel_reason = h.cancel_reason or "error"
                h._close_now()
                if tr is not None and h.request.phase not in TERMINAL_PHASES:
                    # crash containment tears the request down without going
                    # through cancel(): FAIL is its single terminal event.
                    # No clock read — stamp with the request's last known
                    # event time (the run is dead; parity is moot, the
                    # one-terminal invariant is not).
                    req = h.request
                    t = req.token_times[-1] if req.token_times else req.arrival
                    tr.emit(
                        EventType.FAIL, t, rid=req.rid, tenant=req.tenant,
                        pool=lbl, reason="stepper-crash",
                    )
            self._handles.clear()
            self._drained.set()
            raise

    async def _step_loop(self) -> None:
        """Mirrors `ServeSession.run` exactly in its clock interactions:
        one `_now()` read per iteration, plus the same idle-sleep bound —
        that equivalence is what the async/sync parity test pins down."""
        srv = self.session.server
        sess = self.session
        while True:
            # ingest before cancel-processing so a cancel that raced its own
            # submit still finds the intent on the schedule
            self._ingest_submits()
            self._process_cancels()
            now = srv._now()
            while self._scheduled and self._scheduled[0].at <= now:
                self._admit(heapq.heappop(self._scheduled))
            if sess.has_work:
                completed = sess.step()
                emitted, self._emitted = self._emitted, []
                for req, tok, _t in emitted:
                    await self._deliver(req, tok)
                for rid in completed:
                    await self._finish(rid)
                await asyncio.sleep(0)  # consumers run between engine steps
            elif self._scheduled:
                nxt = self._scheduled[0]
                if nxt.cancelled:
                    heapq.heappop(self._scheduled)
                    continue
                await self._idle(min(self.idle_wait, max(0.0, nxt.at - srv._now())))
            elif self._submit_intents or self._cancel_intents:
                continue
            elif self._draining:
                self._drained.set()
                return
            else:
                self._wake.clear()
                if not (self._submit_intents or self._cancel_intents):
                    await self._wake.wait()
