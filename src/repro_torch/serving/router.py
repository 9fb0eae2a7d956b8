"""Multi-server routing: one submit/stream/cancel surface over N replicas
(port of ``repro.serving.router``).

`RouterSession` fronts several `AsyncServeSession` replicas (each wrapping
its own `DisaggServer`) behind the exact client surface a single frontend
exposes — ``await submit(...) -> RequestHandle``, ``async for tok in
handle.stream()``, ``cancel(rid)``, ``replay``, ``drain``/``aclose`` — so a
client written against one engine scales to a fleet by swapping the
constructor. Placement is a registered policy (`repro_torch.policies.router`:
``round-robin``, ``least-queued``, ``slack-aware``, ``prefix-affinity``),
chosen at submit time from the router's own view of each replica.

Two prefix tries per replica (DESIGN.md §router):

  * the **routing index** (`ReplicaState.route_index`) is the router's
    record of which prefixes it sent where — updated at *routing* time,
    probed by ``prefix-affinity``. A real router can't read replica
    internals, so it routes on what it routed.
  * the **session cache** (the replica `ServeSession`'s `PrefixCache`) does
    admission-time hit accounting and grants the `SlotAllocator` KV budget
    credit. It is deliberately separate: inserting at routing time would
    make every request hit its own just-routed prefix.

Determinism: the router adds no clock reads of its own. ``submit`` picks a
replica synchronously (policies are pure functions of the router's view)
and delegates to that replica's frontend with the same ``at``; with one
replica the awaited call sequence is identical to a bare
`AsyncServeSession`, so a 1-replica routed run reproduces the async-engine
backend bit-for-bit on a `ManualClock` (pinned in tests/test_torch_router.py). One
scoping note: replica sessions carry a `PrefixCache`, whose only timing
effect is the `SlotAllocator` KV-budget credit — the parity is exact while
``kv_cap_tokens`` stays slack (true of every shipped engine config; a
config whose cap binds admits more under the credit, by design). With N
replicas each stepper owns its own clock and session, so per-replica
timelines depend only on what was routed there — deterministic given
deterministic routing.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.request import TERMINAL_PHASES, Request
from repro_torch.obs.events import EventType, TraceRecorder
from repro_torch.policies import PolicySpec, make_router
from repro_torch.serving.engine import DisaggServer
from repro_torch.serving.frontend import AsyncServeSession, RequestHandle, drive_replay
from repro_torch.serving.prefixcache import DEFAULT_PREFIX_BLOCK, PrefixCache
from repro_torch.serving.session import FROM_CONFIG


@dataclass
class ReplicaState:
    """The router's view of one replica — everything a `RouterPolicy` may
    consult, derived from requests *this router* routed there (no reach
    into stepper internals, so the view is valid mid-flight).

    The view is live: phases and prefill progress are read at decision
    time. Under live interleaved submission that means real load; under
    upfront open-loop ``replay`` (every submission scheduled before the
    first engine step) routed work hasn't started yet, so `least-queued` /
    `slack-aware` reduce to greedy predicted-load balancing over assigned
    counts / token mass — still the right greedy decision with the
    information a router has at that instant.
    """

    index: int
    frontend: AsyncServeSession
    route_index: PrefixCache
    assigned: int = 0  # total ever routed here (terminal ones included)
    routed: List[Request] = field(default_factory=list)  # non-terminal view
    # fleet liveness (repro_torch.serving.fleetctl): a dead replica stays in
    # `replicas` so indices/owner records remain stable, but is never
    # routed to again; a draining one finishes its work before scale-down
    alive: bool = True
    draining: bool = False

    def _live(self) -> List[Request]:
        # prune terminal requests as they are observed, so per-submit scans
        # stay O(in-flight) instead of O(everything ever routed) and the
        # list doesn't pin every Request for the session's lifetime
        self.routed = [r for r in self.routed if r.phase not in TERMINAL_PHASES]
        return self.routed

    @property
    def in_flight(self) -> int:
        """Routed requests that have not reached a terminal phase."""
        return len(self._live())

    @property
    def pending_prefill_tokens(self) -> int:
        """Prompt tokens routed here whose prefill hasn't finished — the
        backlog a new arrival queues behind."""
        return sum(r.remaining_prefill_tokens for r in self._live())

    @property
    def mu(self) -> float:
        """The replica's online prefill-throughput estimate (tokens/s)."""
        return self.frontend.session.server.mu.mu

    def prefix_match(self, prompt: Sequence[int]) -> int:
        """Longest prefix (tokens) the router already sent this replica."""
        return self.route_index.match(prompt)


class RouterSession:
    """N `AsyncServeSession` replicas behind one submit/stream/cancel surface."""

    def __init__(
        self,
        servers: Sequence[DisaggServer],
        policy: Union[str, PolicySpec] = "round-robin",
        max_queue_depth: Any = FROM_CONFIG,
        tenant_queue_depth: Any = FROM_CONFIG,
        stream_buffer: int = 16,
        backpressure: str = "block",
        prefix_block: int = DEFAULT_PREFIX_BLOCK,
        prefix_cache_blocks: Optional[int] = None,
        trace: Optional[TraceRecorder] = None,
    ):
        if not servers:
            raise ValueError("RouterSession needs at least one server")
        self.policy = make_router(policy)
        self.prefix_block = prefix_block
        # one shared recorder across all replicas: each replica stamps its
        # own pool label ("replica:i"), so the fleet shares one timeline
        self.trace = trace
        self.replicas: List[ReplicaState] = [
            ReplicaState(
                index=i,
                frontend=AsyncServeSession(
                    srv,
                    max_queue_depth=max_queue_depth,
                    tenant_queue_depth=tenant_queue_depth,
                    stream_buffer=stream_buffer,
                    backpressure=backpressure,
                    prefix_cache=PrefixCache(
                        block=prefix_block, max_blocks=prefix_cache_blocks
                    ),
                    trace=trace,
                    trace_label=f"replica:{i}",
                ),
                route_index=PrefixCache(
                    block=prefix_block, max_blocks=prefix_cache_blocks
                ),
            )
            for i, srv in enumerate(servers)
        ]
        self._owner: Dict[int, int] = {}  # rid -> replica index
        self._handles: Dict[int, RequestHandle] = {}

    # ------------------------------------------------------------ lifecycle
    async def __aenter__(self) -> "RouterSession":
        self.start()
        return self

    async def __aexit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            await self.drain()
        else:
            await self.aclose()

    def start(self) -> None:
        for rep in self.replicas:
            rep.frontend.start()

    @staticmethod
    async def _settle_all(coros) -> None:
        """Await every replica before re-raising the first failure: a bare
        gather would propagate one replica's crash immediately, orphaning
        the other replicas' drains/steppers mid-teardown."""
        import asyncio

        results = await asyncio.gather(*coros, return_exceptions=True)
        for res in results:
            if isinstance(res, BaseException):
                raise res

    async def drain(self) -> None:
        """Wait for every replica's admitted work to finish, then stop all
        steppers. A replica crash re-raises only after the others drained."""
        await self._settle_all(rep.frontend.drain() for rep in self.replicas)

    async def aclose(self) -> None:
        await self._settle_all(rep.frontend.aclose() for rep in self.replicas)

    # -------------------------------------------------------------- submit
    async def submit(
        self, request: Request, prompt: Sequence[int], at: Optional[float] = None
    ) -> RequestHandle:
        """Route then delegate: the policy picks a replica from the current
        router view, the routing index records the prompt's prefix there,
        and the replica frontend takes over (admission control included —
        a routed request can still be shed by its replica's quotas)."""
        cands = self._routable()
        if not cands:
            raise RuntimeError("no live replica to route to (all dead/draining)")
        k = self.policy.select(cands, request, prompt)
        if not 0 <= k < len(cands):
            raise ValueError(
                f"router policy {self.policy.name!r} chose replica {k} "
                f"of {len(cands)}"
            )
        rep = cands[k]
        idx = rep.index
        # delegate BEFORE recording the route: if the frontend rejects the
        # call outright (length mismatch, not started), no phantom load or
        # phantom prefix affinity may survive on the replica's books
        handle = await rep.frontend.submit(request, prompt, at=at)
        rep.route_index.admit(prompt)
        rep.assigned += 1
        rep.routed.append(request)
        self._owner[request.rid] = idx
        self._handles[request.rid] = handle
        if self.trace is not None:
            # routing happens before the replica stepper runs admission, so
            # ROUTE precedes the rid's SUBMIT in the shared timeline. No
            # clock read: stamped with the scheduled submission time.
            self.trace.emit(
                EventType.ROUTE,
                request.arrival if at is None else at,
                rid=request.rid, tenant=request.tenant,
                pool=f"replica:{idx}", policy=self.policy.name,
            )
        return handle

    def _routable(self) -> List[ReplicaState]:
        """Replicas new work may land on. With every replica alive this is
        `self.replicas` itself, so policies see the identical view (and the
        identical indices) they always did — the bit-parity contracts hold.
        Policies receive the candidate list and return an index *into it*;
        `ReplicaState.index` maps back to the stable fleet index."""
        if all(rep.alive and not rep.draining for rep in self.replicas):
            return self.replicas
        return [rep for rep in self.replicas if rep.alive and not rep.draining]

    def cancel(self, rid: int) -> bool:
        """Withdraw a routed request on whichever replica owns it (client
        disconnect); False for unknown/never-routed rids."""
        handle = self._handles.get(rid)
        if handle is None:
            return False
        handle.cancel()
        return True

    def owner_of(self, rid: int) -> Optional[int]:
        """Replica index a rid was routed to (None if never routed)."""
        return self._owner.get(rid)

    # -------------------------------------------------------------- replay
    async def replay(
        self,
        pairs: Sequence[Tuple[Request, Sequence[int]]],
        clients: int = 4,
        on_client_token: Optional[Any] = None,
    ) -> Dict[int, List[int]]:
        """Open-loop replay across the fleet: the same `drive_replay` body
        `AsyncServeSession.replay` runs (identical submit order and consumer
        structure), which is what makes the 1-replica routed run
        bit-identical to it."""
        await drive_replay(self.submit, pairs, clients, on_client_token)
        return self.outputs

    # ------------------------------------------------------------- metrics
    @property
    def outputs(self) -> Dict[int, List[int]]:
        """rid -> output tokens, merged across replicas (rids are global;
        lists are copies, so callers can't corrupt session state)."""
        merged: Dict[int, List[int]] = {}
        for rep in self.replicas:
            for rid, toks in rep.frontend.session.outputs.items():
                merged[rid] = list(toks)
        return merged

    def prefix_summary(self) -> Dict[str, Any]:
        """Session-level (admission) prefix-hit accounting, per replica and
        aggregated — the hit rate routing policies compete on."""
        per = []
        hit_tokens = lookup_tokens = lookups = hits = 0
        for rep in self.replicas:
            m = rep.frontend.session.metrics
            per.append(
                dict(
                    replica=rep.index,
                    lookups=m.prefix_lookups,
                    hits=m.prefix_hits,
                    hit_tokens=m.prefix_hit_tokens,
                    lookup_tokens=m.prefix_lookup_tokens,
                    hit_rate=(
                        m.prefix_hit_tokens / m.prefix_lookup_tokens
                        if m.prefix_lookup_tokens
                        else 0.0
                    ),
                )
            )
            lookups += m.prefix_lookups
            hits += m.prefix_hits
            hit_tokens += m.prefix_hit_tokens
            lookup_tokens += m.prefix_lookup_tokens
        return dict(
            block=self.prefix_block,  # hit rates are only comparable per block size
            per_replica=per,
            lookups=lookups,
            hits=hits,
            hit_tokens=hit_tokens,
            lookup_tokens=lookup_tokens,
            hit_rate=hit_tokens / lookup_tokens if lookup_tokens else 0.0,
        )

    def summary(self) -> Dict[str, Any]:
        """One fleet-level report: aggregated session counters, the routing
        decision record, prefix-hit accounting, and each replica's full
        `ServeSession.summary()` under ``per_replica``."""
        per_replica = []
        agg = dict(
            submitted=0, accepted=0, rejected=0, rejected_global=0,
            rejected_tenant=0, completed=0, cancelled=0, backpressure_shed=0,
        )
        requests: List[Dict[str, Any]] = []
        for rep in self.replicas:
            s = rep.frontend.summary()
            for k in agg:
                agg[k] += s[k]
            requests.extend(
                dict(row, replica=rep.index) for row in s["requests"]
            )
            per_replica.append(dict(replica=rep.index, assigned=rep.assigned, **s))
        requests.sort(key=lambda row: row["rid"])
        return dict(
            routing=dict(
                policy=self.policy.name,
                replicas=len(self.replicas),
                assigned=[rep.assigned for rep in self.replicas],
            ),
            prefix=self.prefix_summary(),
            per_replica=per_replica,
            requests=requests,
            **agg,
        )
