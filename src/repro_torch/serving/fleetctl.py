"""Fleet control plane: replica failover + SLO-driven elastic autoscaling
(port of ``repro.serving.fleetctl``; one departure, under wall clocks only:
a replica built by scale-up joins the fleet's time origin, ROADMAP C4).

`FleetSession` extends `RouterSession` with the two control loops a real
serving fleet runs above its router (ROADMAP: fault tolerance; PAPER §6):

  * **Failover.** `kill_replica(i)` injects a replica death mid-flight
    (`AsyncServeSession.kill` — no goodbyes, no terminal events). The
    controller then runs the `repro_torch.dist.fault.plan_recovery` narrative
    against the *live* session: drain (the dead stepper is gone; nothing
    new lands there), checkpoint (`SlotAllocator.snapshot` of the dead
    decode allocator — the KV bookkeeping a restore would replay),
    re-mesh (`plan_mesh` over the surviving "pods"), restart
    (`DisaggServer.reset_for_restart` rebuilds the carcass's engine
    state). Every request that was in flight on the dead replica is
    re-submitted onto a survivor as a *twin* request and its client
    stream is spliced: tokens the client already holds are skipped
    (greedy temperature-0 decoding regenerates the identical prefix), so
    the client sees exactly-once delivery with no duplicated or dropped
    tokens and the rid reaches exactly one terminal event fleet-wide.
  * **Autoscaling.** An `AutoscaleController` periodically feeds
    `repro_torch.obs.slo.windowed_slo` output — the same windowed telemetry an
    operator's dashboard shows, never session internals — to a registered
    `AutoscalerPolicy` (`repro_torch.policies.autoscale`: ``static``,
    ``queue-threshold``, ``slo-attainment-pid``). Scale-up builds a fresh
    replica from ``server_factory`` and warms its prefix state from the
    survivors (`PrefixCache.merge_from` on both the routing index and the
    session cache) so ``prefix-affinity`` routing treats it as a peer from
    its first request; scale-down drains the least-loaded replica and
    retires it only once idle.

Time-aware routing. Unlike `RouterSession` (which routes each submission
the moment ``submit`` is awaited — correct for open-loop parity runs),
`FleetSession` defers the routing decision until the fleet's virtual time
reaches the request's scheduled arrival, so placement sees the liveness
and load that exist *at arrival*: a replica killed at t=2 receives none of
the t>2 arrivals, and a replica scaled up at t=3 starts absorbing the
crowd immediately. Fleet time is observed with `DisaggServer.peek_now`
(observation-only: no clock auto-step, no perturbation of replica
timelines — the controller can poll as often as it likes).

Event vocabulary (`repro_torch.obs.events`): REPLICA_DOWN / REPLICA_UP for
membership changes, RESTORE per re-homed rid (with its stream splice
point), SCALE per applied autoscaler decision. A restored rid re-emits
SUBMIT/ADMIT on its new replica; the windowed queue gauge keeps the dead
replica's undecremented admissions — deliberately, since a standing
post-kill gauge is exactly the evidence ``queue-threshold`` should scale
up on. See docs/OPERATORS.md for the operator-facing runbook of the
reference, which this controller follows.
"""
from __future__ import annotations

import asyncio
import heapq
from typing import (
    Any,
    AsyncIterator,
    Dict,
    List,
    Optional,
    Sequence,
    Tuple,
    Union,
)

from repro_torch.core.request import TERMINAL_PHASES, Phase, Request
from repro_torch.dist.fault import POD_CHIPS, FleetState, plan_recovery
from repro_torch.obs.events import EventType, TraceRecorder
from repro_torch.obs.slo import windowed_slo
from repro_torch.policies import PolicySpec, make_autoscaler
from repro_torch.serving.engine import DisaggServer
from repro_torch.serving.frontend import _EOS, AsyncServeSession, RequestHandle
from repro_torch.serving.prefixcache import DEFAULT_PREFIX_BLOCK, PrefixCache
from repro_torch.serving.router import ReplicaState, RouterSession
from repro_torch.serving.session import FROM_CONFIG


class FleetHandle:
    """The client's view of one request submitted to a `FleetSession`.

    Same surface as `repro_torch.serving.frontend.RequestHandle` (``admitted`` /
    ``stream`` / ``result`` / ``cancel`` / ``cancel_reason``), but decoupled
    from any single replica: a background *pump* task forwards tokens from
    whichever replica currently owns the request, and failover re-points the
    pump at the survivor without the client noticing. ``delivered`` counts
    tokens actually handed to this queue — the stream splice point a restore
    must skip past.
    """

    def __init__(self, fleet: "FleetSession", request: Request, buffer: int):
        self._fleet = fleet
        self.request = request
        # mirror RequestHandle's reserved slots: final token + EOS must land
        # even when the advertised buffer is full
        self._queue: asyncio.Queue = asyncio.Queue(maxsize=buffer + 2)
        self._admit_event = asyncio.Event()
        self._accepted: Optional[bool] = None
        self._closed = False
        self.cancel_reason: Optional[str] = None
        self.delivered = 0  # tokens put into this queue (client-visible)
        # tokens harvested from a dead replica's buffer, owed to the client
        # before the survivor's stream resumes
        self._pending: List[int] = []

    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def tokens(self) -> List[int]:
        """Tokens produced so far, from whichever replica owns the rid."""
        return self._fleet.outputs.get(self.rid, [])

    async def admitted(self) -> bool:
        await self._admit_event.wait()
        return bool(self._accepted)

    async def stream(self) -> AsyncIterator[int]:
        """Yield tokens until the request finishes — across failovers.

        A shed request yields nothing; leaving early cancels the request
        on whichever replica currently owns it.
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
        """Drain the stream; returns exactly the tokens delivered to this
        client (the no-duplication/no-drop guarantee is on this list)."""
        out: List[int] = []
        async for tok in self.stream():
            out.append(tok)
        return out

    def cancel(self) -> None:
        """Withdraw the request (idempotent; no-op after DONE/FAILED)."""
        if self.request.phase in TERMINAL_PHASES:
            return
        while not self._queue.empty():  # wake a pump parked on a full buffer
            try:
                self._queue.get_nowait()
            except asyncio.QueueEmpty:  # pragma: no cover - single-threaded
                break
        self._fleet.cancel(self.rid)

    # ---- fleet-side plumbing (pump / controller only) --------------------
    def _resolve(self, accepted: bool) -> None:
        if self._accepted is not None:  # idempotent across failovers
            return
        self._accepted = accepted
        self._admit_event.set()
        if not accepted:
            self._close_now()

    def _close_now(self) -> None:
        if self._closed:
            return
        self._closed = True
        while not self._queue.empty():
            self._queue.get_nowait()
        self._queue.put_nowait(_EOS)

    async def _finish(self) -> None:
        if self._closed:
            return
        self._closed = True
        await self._queue.put(_EOS)


class _FleetIntent:
    """A fleet submission waiting for its routing moment."""

    __slots__ = ("at", "seq", "request", "prompt", "handle", "cancelled")

    def __init__(self, at: float, seq: int, request: Request,
                 prompt: List[int], handle: FleetHandle):
        self.at, self.seq = at, seq
        self.request, self.prompt, self.handle = request, prompt, handle
        self.cancelled = False

    def __lt__(self, other: "_FleetIntent") -> bool:
        return (self.at, self.seq) < (other.at, other.seq)


class AutoscaleController:
    """Telemetry-in, membership-out: the autoscaling decision loop.

    Every ``interval`` virtual seconds it computes `windowed_slo` over the
    fleet's shared event stream and asks its `AutoscalerPolicy` for a target
    replica count. The target is clamped to ``[n_min, n_max]`` and applied
    at most one replica per tick (scale thrash is worse than a slow ramp).
    The controller never reads replica/session internals — only the event
    stream — so any policy that works here works on an offline trace too.
    """

    def __init__(
        self,
        fleet: "FleetSession",
        policy: Union[str, PolicySpec] = "static",
        interval: float = 0.5,
        window: float = 0.5,
        n_min: int = 1,
        n_max: int = 8,
    ):
        if interval < 0:
            raise ValueError(f"autoscale interval must be >= 0, got {interval}")
        if window <= 0:
            raise ValueError(f"slo window must be > 0, got {window}")
        if not 1 <= n_min <= n_max:
            raise ValueError(f"need 1 <= n_min <= n_max, got [{n_min}, {n_max}]")
        self.fleet = fleet
        self.policy = make_autoscaler(policy)
        self.interval = float(interval)
        self.window = float(window)
        self.n_min = int(n_min)
        self.n_max = int(n_max)
        self._next_eval = self.interval
        self.decisions: List[Dict[str, Any]] = []

    async def maybe_tick(self, now: float) -> None:
        if self.interval <= 0 or now < self._next_eval:
            return
        self._next_eval = (int(now / self.interval) + 1) * self.interval
        slo = windowed_slo(self.fleet.trace.events, self.window)
        n_live = self.fleet.n_live
        target = int(self.policy.decide(slo, n_live, self.n_min, self.n_max))
        target = max(self.n_min, min(self.n_max, target))
        if target == n_live:
            return
        action = "up" if target > n_live else "down"
        last = slo["windows"][-1] if slo["windows"] else {}
        evidence = dict(
            n_windows=slo["n_windows"],
            queue_depth_max=last.get("queue_depth_max", 0),
            queue_depth_last=last.get("queue_depth_last", 0),
            e2e=last.get("e2e", 0.0),
            done=last.get("done", 0),
            shed=last.get("shed", 0),
        )
        if action == "up":
            applied = await self.fleet._scale_up(now)
        else:
            applied = self.fleet._begin_scale_down(now)
        self.decisions.append(
            dict(t=now, policy=self.policy.name, action=action,
                 applied=applied, n_before=n_live, n_target=target)
        )
        self.fleet.trace.emit(
            EventType.SCALE, now, pool="fleet",
            policy=self.policy.name, action=action, applied=applied,
            n_before=n_live, n_after=self.fleet.n_live, evidence=evidence,
        )


class FleetSession(RouterSession):
    """`RouterSession` + failover + elastic autoscaling (module docstring).

    Extra parameters over `RouterSession`:

    autoscaler          AutoscalerPolicy spec (name / (name, kwargs) / dict)
    n_min, n_max        live-replica bounds the controller may move between
    autoscale_interval  virtual seconds between autoscaler evaluations
                        (0 disables evaluation; kill_schedule still fires)
    slo_window          window (virtual s) for the telemetry the policy sees
    kill_schedule       iterable of ``(t, replica_index)`` fault injections,
                        fired when fleet time first reaches ``t``
    server_factory      zero-arg callable building a fresh `DisaggServer`
                        for scale-up (None: scale-up decisions are recorded
                        but not applied)
    """

    def __init__(
        self,
        servers: Sequence[DisaggServer],
        policy: Union[str, PolicySpec] = "round-robin",
        autoscaler: Union[str, PolicySpec] = "static",
        n_min: int = 1,
        n_max: int = 8,
        autoscale_interval: float = 0.5,
        slo_window: float = 0.5,
        kill_schedule: Sequence[Tuple[float, int]] = (),
        server_factory: Optional[Any] = None,
        max_queue_depth: Any = FROM_CONFIG,
        tenant_queue_depth: Any = FROM_CONFIG,
        stream_buffer: int = 16,
        backpressure: str = "block",
        prefix_block: int = DEFAULT_PREFIX_BLOCK,
        prefix_cache_blocks: Optional[int] = None,
        trace: Optional[TraceRecorder] = None,
    ):
        # the control plane runs ON the telemetry: a fleet always records
        super().__init__(
            servers,
            policy=policy,
            max_queue_depth=max_queue_depth,
            tenant_queue_depth=tenant_queue_depth,
            stream_buffer=stream_buffer,
            backpressure=backpressure,
            prefix_block=prefix_block,
            prefix_cache_blocks=prefix_cache_blocks,
            trace=trace if trace is not None else TraceRecorder(),
        )
        self.server_factory = server_factory
        self.stream_buffer = stream_buffer
        self._prefix_cache_blocks = prefix_cache_blocks
        # kwargs a scale-up replica's frontend is built with
        self._fe_kwargs = dict(
            max_queue_depth=max_queue_depth,
            tenant_queue_depth=tenant_queue_depth,
            stream_buffer=stream_buffer,
            backpressure=backpressure,
        )
        self.controller = AutoscaleController(
            self, policy=autoscaler, interval=autoscale_interval,
            window=slo_window, n_min=n_min, n_max=n_max,
        )
        self._kills: List[Tuple[float, int]] = sorted(
            (float(t), int(i)) for t, i in kill_schedule
        )
        self.kills_skipped: List[Tuple[float, int]] = []
        self._virtual = all(
            hasattr(rep.frontend.session.server.clock, "advance")
            for rep in self.replicas
        )

        self._seq = 0
        self._pending: List[_FleetIntent] = []  # heap: (at, seq)
        self._unrouted: Dict[int, _FleetIntent] = {}
        self._fleet_handles: Dict[int, FleetHandle] = {}
        self._pumps: Dict[int, asyncio.Task] = {}
        self._old_pumps: List[asyncio.Task] = []
        self._draining_idx: set = set()
        self._ctl: Optional[asyncio.Task] = None

        self.recoveries: List[Dict[str, Any]] = []
        self.kill_count = 0
        self.restore_count = 0
        self.reschedule_count = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.preroute_cancelled = 0

    # ------------------------------------------------------------ liveness
    @property
    def n_live(self) -> int:
        return sum(1 for r in self.replicas if r.alive and not r.draining)

    def _fleet_now(self) -> float:
        """Observation-only fleet time: the furthest live replica clock.
        `peek_now` never auto-steps, so polling here cannot perturb any
        replica's timeline."""
        ts = [
            rep.frontend.session.server.peek_now()
            for rep in self.replicas
            if rep.alive
        ]
        return max(ts) if ts else 0.0

    def _fleet_idle(self) -> bool:
        """True when no live replica has admitted work or queued intents —
        the next thing that can happen in virtual time is a future fleet
        intent, so the router may dispatch it early and let the owning
        replica idle-advance to its arrival."""
        for rep in self.replicas:
            if not rep.alive:
                continue
            fe = rep.frontend
            if fe.session.has_work or fe._scheduled or fe._submit_intents:
                return False
        return True

    # ----------------------------------------------------------- lifecycle
    def start(self) -> None:
        super().start()
        self._ctl = asyncio.get_running_loop().create_task(
            self._control_loop(), name="fleet-controller"
        )

    async def drain(self) -> None:
        """Route every pending fleet intent, drain the replicas (the
        controller keeps running, so kills/scale decisions scheduled inside
        the workload still fire mid-drain), then stop the controller and
        settle every pump. Kill-schedule entries the run never reached are
        recorded in ``kills_skipped``."""
        while self._pending:
            if self._ctl is not None and self._ctl.done():
                self._ctl.result()  # surface a controller crash
            await asyncio.sleep(0)
        await super().drain()
        await self._stop_controller(surface=True)
        self.kills_skipped.extend(self._kills)
        self._kills.clear()
        pumps = [t for t in self._pumps.values() if not t.done()]
        if pumps:
            await asyncio.gather(*pumps)

    async def aclose(self) -> None:
        await self._stop_controller(surface=False)
        for task in list(self._pumps.values()) + self._old_pumps:
            task.cancel()
        await asyncio.gather(
            *self._pumps.values(), *self._old_pumps, return_exceptions=True
        )
        for intent in self._unrouted.values():
            intent.cancelled = True
            intent.handle.cancel_reason = intent.handle.cancel_reason or "client"
            intent.handle._resolve(False)
        self._pending.clear()
        self._unrouted.clear()
        await super().aclose()
        for fh in self._fleet_handles.values():
            fh._close_now()

    async def _stop_controller(self, surface: bool) -> None:
        ctl, self._ctl = self._ctl, None
        if ctl is None:
            return
        if ctl.done():
            if surface:
                ctl.result()
            return
        ctl.cancel()
        try:
            await ctl
        except asyncio.CancelledError:
            pass

    # -------------------------------------------------------------- submit
    async def submit(  # type: ignore[override]
        self, request: Request, prompt: Sequence[int], at: Optional[float] = None
    ) -> FleetHandle:
        """Accept a request into the fleet; routing happens when fleet time
        reaches ``at`` (None: next controller pass), so placement sees the
        replica set as it exists at arrival — not at submission."""
        if self._ctl is None:
            raise RuntimeError("fleet not started (use `async with` or start())")
        if request.input_len != len(prompt):
            raise ValueError(
                f"request rid={request.rid} declares input_len={request.input_len} "
                f"but prompt has {len(prompt)} tokens"
            )
        fh = FleetHandle(self, request, self.stream_buffer)
        intent = _FleetIntent(
            float("-inf") if at is None else at, self._seq, request,
            list(prompt), fh,
        )
        self._seq += 1
        heapq.heappush(self._pending, intent)
        self._unrouted[request.rid] = intent
        self._fleet_handles[request.rid] = fh
        return fh

    def cancel(self, rid: int) -> bool:
        """Withdraw a request wherever it currently lives: still waiting for
        its routing moment (terminates here, CANCEL stage="pre-route"), or
        on whichever replica owns it."""
        intent = self._unrouted.get(rid)
        if intent is not None:
            if intent.cancelled:
                return True
            intent.cancelled = True
            del self._unrouted[rid]
            req = intent.request
            if req.phase not in TERMINAL_PHASES:
                req.phase = Phase.CANCELLED
                self.preroute_cancelled += 1
                # same SUBMIT+CANCEL pair the frontend's pre-admission path
                # emits, stamped with the declared arrival (no clock read)
                self.trace.emit(
                    EventType.SUBMIT, req.arrival, rid=req.rid,
                    tenant=req.tenant, pool="fleet", arrival=req.arrival,
                    input_len=req.input_len, output_len=req.output_len,
                    slo_ttft=req.slo.ttft, slo_tpot=req.slo.tpot,
                    slo_class=req.slo_class,
                )
                self.trace.emit(
                    EventType.CANCEL, req.arrival, rid=req.rid,
                    tenant=req.tenant, pool="fleet", stage="pre-route",
                )
            intent.handle.cancel_reason = "client"
            intent.handle._resolve(False)
            return True
        return super().cancel(rid)

    # ------------------------------------------------------------- routing
    async def _route_intent(self, intent: _FleetIntent) -> None:
        if intent.cancelled:
            return
        fh = intent.handle
        at = None if intent.at == float("-inf") else intent.at
        try:
            inner = await RouterSession.submit(self, intent.request, intent.prompt, at=at)
        except RuntimeError:
            # no live replica to route to: fail the stream, don't kill the
            # controller — the fleet may grow again
            fh.cancel_reason = fh.cancel_reason or "error"
            fh._resolve(False)
            self._unrouted.pop(intent.request.rid, None)
            return
        self._unrouted.pop(intent.request.rid, None)
        self._bind_pump(fh, inner, skip=0)

    def _bind_pump(
        self,
        fh: FleetHandle,
        inner: RequestHandle,
        skip: int,
        orig: Optional[Request] = None,
    ) -> None:
        task = asyncio.get_running_loop().create_task(
            self._pump(fh, inner, skip, orig), name=f"fleet-pump-{fh.rid}"
        )
        self._pumps[fh.rid] = task

    async def _pump(
        self, fh: FleetHandle, inner: RequestHandle, skip: int,
        orig: Optional[Request],
    ) -> None:
        """Forward one replica handle into the fleet handle. ``skip`` tokens
        of the inner stream are dropped (the client already holds them from
        before a failover — greedy decoding regenerates the identical
        prefix); tokens harvested from the dead replica's buffer
        (``fh._pending``) are delivered first."""
        ok = await inner.admitted()
        fh._resolve(ok)
        if ok:
            while fh._pending:
                tok = fh._pending.pop(0)
                await fh._queue.put(tok)
                fh.delivered += 1
            seen = 0
            async for tok in inner.stream():
                seen += 1
                if seen <= skip:
                    continue
                await fh._queue.put(tok)
                fh.delivered += 1
        fh.cancel_reason = fh.cancel_reason or inner.cancel_reason
        if orig is not None:
            self._mirror_terminal(orig, inner.request, skip)
        await fh._finish()

    @staticmethod
    def _mirror_terminal(orig: Request, twin: Request, skip: int) -> None:
        """Copy the twin's terminal fate back onto the original `Request`
        object the client (and any harness bookkeeping) still holds. Token
        times splice at the failover point: the first ``skip`` stamps are
        from the dead replica's timeline, the rest from the survivor's."""
        orig.phase = twin.phase
        orig.done_time = twin.done_time
        orig.n_generated = twin.n_generated
        orig.n_decoded = twin.n_decoded
        orig.prefilled_tokens = twin.prefilled_tokens
        orig.token_times = list(orig.token_times[:skip]) + list(twin.token_times[skip:])
        if orig.first_token_time is None:
            orig.first_token_time = twin.first_token_time
        if orig.prefill_finish is None:
            orig.prefill_finish = twin.prefill_finish
        orig.restarts += 1

    # ------------------------------------------------------------- control
    async def _control_loop(self) -> None:
        try:
            while True:
                now = self._fleet_now()
                progressed = False
                while self._kills and self._kills[0][0] <= now:
                    _t, idx = self._kills.pop(0)
                    if 0 <= idx < len(self.replicas) and self.replicas[idx].alive:
                        await self.kill_replica(idx)
                    progressed = True
                while self._pending and self._pending[0].cancelled:
                    heapq.heappop(self._pending)
                while self._pending and self._pending[0].at <= now:
                    await self._route_intent(heapq.heappop(self._pending))
                    progressed = True
                    while self._pending and self._pending[0].cancelled:
                        heapq.heappop(self._pending)
                if not progressed and self._pending and self._fleet_idle():
                    # nothing is running anywhere and the next arrival is in
                    # the future: dispatch it and let its replica idle-step
                    # forward — this is what advances fleet time through gaps
                    await self._route_intent(heapq.heappop(self._pending))
                    progressed = True
                await self.controller.maybe_tick(now)
                await self._reap_draining(now)
                # virtual fleets spin on the event loop (time is advanced by
                # the steppers); wall-clock fleets must actually sleep
                await asyncio.sleep(0 if self._virtual else 0.005)
        except asyncio.CancelledError:
            raise
        except BaseException:
            for intent in self._unrouted.values():
                if intent.handle._accepted is None:
                    intent.cancelled = True
                    intent.handle.cancel_reason = (
                        intent.handle.cancel_reason or "error"
                    )
                    intent.handle._resolve(False)
            self._pending.clear()
            self._unrouted.clear()
            raise

    # ------------------------------------------------------------ failover
    async def kill_replica(self, index: int, reason: str = "killed") -> Dict[str, Any]:
        """Inject a replica death and fail its in-flight work over.

        Runs the `plan_recovery` sequence against the live session: the
        dead stepper is cancelled mid-step (drain — nothing else lands
        there), its `SlotAllocator` is snapshotted (checkpoint), the
        surviving replicas are re-meshed (`plan_mesh` narrative), the
        carcass's engine state is rebuilt (`reset_for_restart`), and every
        request that was in flight is restored onto a survivor with its
        client stream spliced at the delivered-token count. Returns the
        recovery record (also appended to ``recoveries``)."""
        rep = self.replicas[index]
        if not rep.alive:
            raise RuntimeError(f"replica {index} is already dead")
        if self.n_live <= 1 and not rep.draining:
            raise RuntimeError(
                "refusing to kill the last live replica: nowhere to restore "
                "its in-flight requests"
            )
        rep.alive = False
        rep.draining = False
        self._draining_idx.discard(index)
        fe = rep.frontend
        sess = fe.session
        server = sess.server

        # -- drain + checkpoint: stop the stepper where the crash found it,
        #    snapshot the KV bookkeeping a restore would replay
        await fe.kill()
        snap = server.decode.alloc.snapshot()
        t_kill = server.peek_now()

        # -- harvest: admitted work (queue/transfer/decode) and submissions
        #    the dead stepper never admitted
        victims = [lr for lr in sess.queue + sess.waiting_adm + sess.active]
        unadmitted = [
            it for it in list(fe._scheduled) + list(fe._submit_intents)
            if not it.cancelled and it.handle._accepted is None
        ]
        lost_cancels = list(fe._cancel_intents)

        restored: List[int] = []
        rescheduled: List[int] = []
        plans: List[Tuple[Request, List[int], Optional[float], int, Optional[Request]]] = []

        m = sess.metrics
        for lr in victims:
            orig = lr.req
            rid = orig.rid
            fh = self._fleet_handles.get(rid)
            if fh is None:  # not fleet-submitted (defensive): drop silently
                continue
            await self._retire_pump(rid)
            inner = fe._handles.get(rid)
            if inner is not None:  # salvage generated-but-undelivered tokens
                while not inner._queue.empty():
                    item = inner._queue.get_nowait()
                    if item is not _EOS:
                        fh._pending.append(item)
            delivered = fh.delivered + len(fh._pending)
            # the books move with the request: un-count it from the dead
            # session so fleet aggregates don't double-count the twin
            m.submitted -= 1
            m.accepted -= 1
            tcount = m.submitted_by_tenant.get(orig.tenant, 0) - 1
            if tcount > 0:
                m.submitted_by_tenant[orig.tenant] = tcount
            else:
                m.submitted_by_tenant.pop(orig.tenant, None)
            if orig in sess.requests:
                sess.requests.remove(orig)
            sess.outputs.pop(rid, None)
            twin = Request(
                rid=orig.rid, arrival=orig.arrival,
                input_len=orig.input_len, output_len=orig.output_len,
                slo=orig.slo, tenant=orig.tenant, slo_class=orig.slo_class,
                prefix_group=orig.prefix_group, prefix_frac=orig.prefix_frac,
            )
            prompt = list(lr.tokens[: orig.input_len])
            plans.append((twin, prompt, t_kill, delivered, orig))
            restored.append(rid)
        for it in unadmitted:
            rid = it.request.rid
            if rid not in self._fleet_handles:
                continue
            await self._retire_pump(rid)
            at = None if it.at == float("-inf") else it.at
            plans.append((it.request, list(it.prompt), at, 0, None))
            rescheduled.append(rid)

        # -- clear the carcass: undo the router's books for harvested rids,
        #    wipe frontend/session state so nothing double-terminates later
        for rid in restored + rescheduled:
            self._handles.pop(rid, None)
            self._owner.pop(rid, None)
            rep.assigned -= 1
        harvested = set(restored) | set(rescheduled)
        rep.routed = [r for r in rep.routed if r.rid not in harvested]
        fe._handles.clear()
        fe._scheduled.clear()
        fe._submit_intents.clear()
        fe._cancel_intents.clear()
        sess.queue.clear()
        sess.waiting_adm.clear()
        sess.active.clear()
        for lr in victims:  # free their prefill KV before the restart reallocates
            lr.prefill_cache = None

        # -- re-mesh narrative + restart: the dead "pod" reports 0 healthy
        #    chips; survivors re-plan, the carcass's engine state is rebuilt
        pods = tuple(POD_CHIPS if r.alive else 0 for r in self.replicas)
        plan = plan_recovery(FleetState(pods=pods))
        server.reset_for_restart()

        # -- restore: twins re-route through the normal policy path, each
        #    pump spliced at its client's delivered-token count
        for twin, prompt, at, delivered, orig in plans:
            fh = self._fleet_handles[twin.rid]
            try:
                inner = await RouterSession.submit(self, twin, prompt, at=at)
            except RuntimeError:  # pragma: no cover - guarded by n_live check
                fh.cancel_reason = fh.cancel_reason or "error"
                fh._resolve(False)
                fh._close_now()
                continue
            self._bind_pump(fh, inner, skip=delivered, orig=orig)
            self.trace.emit(
                EventType.RESTORE, t_kill, rid=twin.rid, tenant=twin.tenant,
                pool=f"replica:{self._owner[twin.rid]}",
                src=index, dst=self._owner[twin.rid], delivered=delivered,
                stage=("scheduled" if orig is None else orig.phase.value),
            )
        for rid in lost_cancels:  # client cancels the dead stepper never saw
            self.cancel(rid)

        record = dict(
            replica=index, t=t_kill, reason=reason,
            snapshot=dict(
                slots_live=len(snap["live_tokens"]),
                free_slots=len(snap["free"]),
                kv_tokens=sum(snap["live_tokens"].values()),
            ),
            restored=restored, rescheduled=rescheduled,
            mesh=dict(
                shape=list(plan.mesh.shape),
                axes=list(plan.mesh.axes),
                dropped_pods=list(plan.mesh.dropped_pods),
            ),
            steps=[list(s) for s in plan.steps]
            + [["restore", f"re-prefill {len(restored)} in-flight + "
                           f"{len(rescheduled)} queued request(s) on survivors"]],
        )
        self.recoveries.append(record)
        self.kill_count += 1
        self.restore_count += len(restored)
        self.reschedule_count += len(rescheduled)
        self.trace.emit(
            EventType.REPLICA_DOWN, t_kill, pool=f"replica:{index}",
            reason=reason, restored=len(restored),
            rescheduled=len(rescheduled),
            slots_live=len(snap["live_tokens"]),
        )
        return record

    async def _retire_pump(self, rid: int) -> None:
        task = self._pumps.pop(rid, None)
        if task is None:
            return
        if not task.done():
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        self._old_pumps.append(task)

    # ----------------------------------------------------------- scaling
    async def _scale_up(self, now: float) -> bool:
        if self.server_factory is None:
            return False
        # un-drain first: a replica on its way out is cheaper to keep than
        # a cold one is to build
        for rep in self.replicas:
            if rep.alive and rep.draining:
                rep.draining = False
                self._draining_idx.discard(rep.index)
                return True
        srv = self.server_factory()
        idx = len(self.replicas)
        fe = AsyncServeSession(
            srv,
            prefix_cache=PrefixCache(
                block=self.prefix_block, max_blocks=self._prefix_cache_blocks
            ),
            trace=self.trace,
            trace_label=f"replica:{idx}",
            **self._fe_kwargs,
        )
        rep = ReplicaState(
            index=idx,
            frontend=fe,
            route_index=PrefixCache(
                block=self.prefix_block, max_blocks=self._prefix_cache_blocks
            ),
        )
        # warm start: inherit the survivors' prefix state so affinity
        # routing treats the newcomer as a peer from its first request
        warmed = 0
        for donor in self.replicas:
            if not donor.alive:
                continue
            warmed += rep.route_index.merge_from(donor.route_index)
            cache = donor.frontend.session.prefix_cache
            if cache is not None and fe.session.prefix_cache is not None:
                fe.session.prefix_cache.merge_from(cache)
        self.replicas.append(rep)
        fe.start()
        if not self._virtual:
            # wall clocks share one time base: put the newcomer on the fleet's
            # origin, or its stepper would hold every routed arrival back
            # until its own clock, zeroed at start, caught up with the
            # arrival's fleet time (repro.serving.fleetctl does that)
            live = next(r for r in self.replicas if r.alive and r is not rep)
            srv._t0 = live.frontend.session.server._t0
        self.scale_ups += 1
        self.trace.emit(
            EventType.REPLICA_UP, now, pool=f"replica:{idx}",
            warmed_blocks=warmed, reason="scale-up",
        )
        return True

    def _begin_scale_down(self, now: float) -> bool:
        cands = [r for r in self.replicas if r.alive and not r.draining]
        if len(cands) <= self.controller.n_min:
            return False
        victim = min(cands, key=lambda r: (r.in_flight, -r.index))
        victim.draining = True
        self._draining_idx.add(victim.index)
        return True

    async def _reap_draining(self, now: float) -> None:
        for idx in sorted(self._draining_idx):
            rep = self.replicas[idx]
            fe = rep.frontend
            if fe.session.has_work or fe._scheduled or fe._submit_intents:
                continue  # still working; check again next tick
            await fe.drain()
            rep.alive = False
            rep.draining = False
            self._draining_idx.discard(idx)
            self.scale_downs += 1
            self.trace.emit(
                EventType.REPLICA_DOWN, now, pool=f"replica:{idx}",
                reason="scale-down", restored=0, rescheduled=0, slots_live=0,
            )

    # ------------------------------------------------------------- metrics
    @property
    def outputs(self) -> Dict[int, List[int]]:
        """rid -> output tokens; the owning replica's copy wins (after a
        failover both the carcass and the survivor may know a rid)."""
        merged: Dict[int, List[int]] = {}
        for rep in self.replicas:
            for rid, toks in rep.frontend.session.outputs.items():
                merged[rid] = list(toks)
        for rid, idx in self._owner.items():
            toks = self.replicas[idx].frontend.session.outputs.get(rid)
            if toks is not None:
                merged[rid] = list(toks)
        return merged

    def summary(self) -> Dict[str, Any]:
        out = super().summary()
        out["fleet"] = dict(
            autoscaler=self.controller.policy.name,
            n_min=self.controller.n_min,
            n_max=self.controller.n_max,
            autoscale_interval=self.controller.interval,
            slo_window=self.controller.window,
            replicas_total=len(self.replicas),
            replicas_live=self.n_live,
            kills=self.kill_count,
            kills_skipped=[list(k) for k in self.kills_skipped],
            restored=self.restore_count,
            rescheduled=self.reschedule_count,
            scale_ups=self.scale_ups,
            scale_downs=self.scale_downs,
            preroute_cancelled=self.preroute_cancelled,
            decisions=list(self.controller.decisions),
            recoveries=list(self.recoveries),
        )
        return out
