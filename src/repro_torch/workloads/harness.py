"""Evaluation harness: (scenario × prefill × decode × backend) grids (a
copy of ``repro.workloads.harness``; the engine-family backends serve
through the port's `DisaggServer` on ``device``, default ``"cuda"``).

One report schema over six backends:

    sim          `DisaggSimulator` via `run_policy` — paper-scale lengths
                 and SLOs, discrete-event time
    engine       the live `DisaggServer` driven through `ServeSession.run`
                 on a deterministic `ManualClock` — real PyTorch compute
                 at demo scale
    async-engine the same server behind the `AsyncServeSession` frontend:
                 requests are submitted open-loop at their arrival times on
                 an asyncio event loop and their token streams drained by
                 ``async_clients`` concurrent consumers — true concurrent
                 admission/delivery rather than a replayed loop. On the
                 shared `ManualClock` its per-request TTFT/TPOT match the
                 `engine` backend bit-for-bit (the async/sync parity
                 contract), so any divergence between those two columns is
                 a frontend bug, not noise.
    router       ``router_replicas`` such servers behind a `RouterSession`
                 (repro_torch.serving.router): placement by ``router_policy``
                 from the routing registry, per-replica prefix caches doing
                 admission-time hit accounting. The cell carries a
                 ``router`` block (per-replica assigned/completed counts +
                 prefix hit rates). With 1 replica it reproduces the
                 async-engine cell bit-for-bit — the routing layer adds no
                 clock reads of its own.
    disagg       a P/D-split fleet (`repro_torch.serving.disagg`): a prefill pool
                 and a decode pool of servers on ONE shared ManualClock,
                 with an explicit KV handoff (priced by
                 ``CostModel.transfer_time``, bounded in-flight window) and
                 registered prefill-deflection policies. The cell carries a
                 ``disagg`` block: handoff/deflection records plus per-pool
                 attainment. A 1P:1D fleet under ``never`` deflection
                 reproduces the 1-replica router cell bit-for-bit.
    churn        the router fleet under a `FleetSession` control plane
                 (repro_torch.serving.fleetctl): injected replica kills with
                 in-flight restore, and an autoscaler on windowed-SLO
                 telemetry. The cell carries a ``churn`` block.

Scenario traces are paper-scale (prompts up to 128K tokens); the engine
backend maps each request onto an engine-scale twin (prompt/output lengths
rescaled into the engine's slot budget, arrivals compressed, tenant /
SLO-class labels preserved) so per-tenant admission quotas, shedding, and
the registry policies are exercised on real compute. Numbers from the two
backends are therefore *not* comparable to each other — the grid is for
attainment-vs-policy structure per backend, not cross-backend deltas.

Every cell reports total and per-tenant / per-SLO-class attainment, goodput
(SLO-met tokens/sec), and shed counts, all derived uniformly from terminal
request phases (`repro_torch.sim.metrics`). `launch/evaluate.py` is the CLI.
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.request import Phase, Request, SLOSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import TraceRecorder, trace_cell_block, write_trace
from repro_torch.sim.metrics import attainment, attainment_by, goodput
from repro_torch.sim.simulator import SimConfig, run_policy
from repro_torch.workloads.scenarios import make_scenario

BACKENDS: Tuple[str, ...] = ("sim", "engine", "async-engine", "router", "disagg", "churn")


def parse_kills(specs: Sequence[str]) -> Tuple[Tuple[float, int], ...]:
    """Parse repeated ``"T:IDX"`` kill specs into a ``(t, replica_index)``
    schedule (virtual seconds on the engine timeline)."""
    out = []
    for spec in specs:
        try:
            t_str, i_str = spec.split(":")
            t, i = float(t_str), int(i_str)
        except ValueError:
            raise ValueError(
                f"kill spec must be 'T:IDX' (virtual seconds : replica index, "
                f"e.g. 0.05:1), got {spec!r}"
            ) from None
        if t < 0 or i < 0:
            raise ValueError(f"kill spec fields must be >= 0, got {spec!r}")
        out.append((t, i))
    return tuple(sorted(out))


def parse_pools(spec: str) -> Tuple[int, int]:
    """Parse a ``"P:D"`` pool-size spec into (prefill, decode) counts."""
    try:
        p_str, d_str = spec.split(":")
        p, d = int(p_str), int(d_str)
    except ValueError:
        raise ValueError(
            f"pool spec must be 'P:D' with integer pool sizes (e.g. 2:2), got {spec!r}"
        ) from None
    if p < 1 or d < 1:
        raise ValueError(f"pool sizes must be >= 1, got {spec!r}")
    return p, d


@dataclass(frozen=True)
class HarnessConfig:
    """Knobs shared by every cell of one grid run."""

    n_requests: Optional[int] = None  # override the scenario's default size
    seed: int = 0
    sim: SimConfig = field(default_factory=SimConfig)

    # engine backend: model + how paper-scale traces map onto it
    engine_arch: str = "llama3-8b-smoke"
    engine_max_prompt: int = 24  # paper-scale inputs rescaled into [2, this]
    engine_max_output: int = 6  # outputs rescaled into [1, this]
    engine_arrival_scale: float = 0.01  # arrivals × this -> engine virtual seconds
    # SLO targets must map into engine virtual time too, or attainment
    # degenerates to the completion rate (every paper-scale target is
    # trivially met under compressed arrivals). TTFT compresses with the
    # arrivals (None = follow engine_arrival_scale, so changing one knob
    # can't silently decouple them); TPOT tracks service time, which does
    # NOT compress, so it gets its own factor.
    engine_slo_ttft_scale: Optional[float] = None
    engine_slo_tpot_scale: float = 0.05

    @property
    def slo_ttft_scale(self) -> float:
        return (
            self.engine_slo_ttft_scale
            if self.engine_slo_ttft_scale is not None
            else self.engine_arrival_scale
        )
    engine_chunk_size: int = 16
    engine_max_slots: int = 8
    engine_max_len: int = 64
    # paged KV (DESIGN.md §kvcache): page_size switches every engine-family
    # backend from contiguous per-slot KV to refcounted pages with radix
    # prefix reuse; None keeps the slot substrate (bit-identical on
    # prefix-free traces — pinned in tests). cache_pages bounds the pool
    # (None = max_slots * max_len / page_size, i.e. slot-equivalent).
    page_size: Optional[int] = None
    cache_pages: Optional[int] = None
    queue_depth: Optional[int] = None  # global admission bound (engine)
    tenant_quota: Optional[int] = None  # per-tenant queued bound (engine)
    # async-engine backend: concurrent stream consumers, per-stream token
    # buffer, and the slow-consumer policy ("block" stalls the engine,
    # "shed" cancels the laggard — see repro_torch.serving.frontend)
    async_clients: int = 4
    stream_buffer: int = 16
    backpressure: str = "block"
    # router backend: N AsyncServeSession replicas behind a RouterSession
    # (repro_torch.serving.router), placement by a registered routing policy;
    # prefix_block is the prefix-trie block size for both the per-replica
    # session caches and the router's routing indexes
    router_replicas: int = 2
    router_policy: str = "least-queued"
    prefix_block: int = 4
    prefix_cache_blocks: Optional[int] = None
    # churn backend: the router fleet under churn — a FleetSession
    # (repro_torch.serving.fleetctl) with injected replica kills and an
    # autoscaler moving the live-replica count within
    # [fleet_min_replicas, fleet_max_replicas] every autoscale_interval
    # virtual seconds, driven by windowed-SLO telemetry over slo_window
    # (falls back to autoscale_interval when slo_window is None)
    churn_kills: Tuple[Tuple[float, int], ...] = ()
    autoscaler_policy: str = "static"
    autoscale_interval: float = 0.05
    fleet_min_replicas: int = 1
    fleet_max_replicas: int = 6
    # disagg backend: prefill/decode pool sizes, the registered deflection
    # policy, KV-transfer pricing (shared by every engine backend's
    # admission handoff via EngineConfig), and the in-flight transfer bound
    disagg_prefill: int = 2
    disagg_decode: int = 2
    deflect_policy: str = "never"
    transfer_lat: float = 0.002
    transfer_bw: float = 900e9
    max_inflight_transfers: int = 8
    # observability (repro_torch.obs): event-trace output. None = tracing off (the
    # default recorder is absent, so no per-event cost at all); "" = record
    # in memory and attach the cell's ``trace`` block but write no file; a
    # path = also export per cell (".jsonl" -> event JSONL, anything else ->
    # Chrome trace-event / Perfetto JSON), with a per-cell suffix so grid
    # cells never clobber each other. ``slo_window`` is the sliding-window
    # width in backend virtual seconds for the trace block's windowed SLO
    # series (None = omit the series).
    trace: Optional[str] = None
    slo_window: Optional[float] = None

    def as_dict(self) -> Dict:
        # the report's run-identity block: every knob (asdict recurses into
        # SimConfig), so two perf records with different settings never
        # diff as if only the numbers moved
        return dataclasses.asdict(self)


@dataclass
class _EngineBundle:
    """Lazily-built model shared by every engine cell of a grid, on
    ``device``: ``Model.init(0)`` of ``arch`` in float32, or a given
    ``(model, params)`` (their config must be ``arch``'s, their tensors on
    ``device``), so one set of weights, of any dtype, can serve many
    grids."""

    arch: str
    device: DeviceLike = "cuda"
    cfg: object = None
    model: object = None
    params: object = None
    built: bool = field(default=False)

    def build(self):
        if not self.built:
            from repro_torch.configs import get_config
            from repro_torch.models import build_model

            self.device = resolve_device(self.device)
            if (self.model is None) != (self.params is None):
                raise ValueError("give both model and params, or neither")
            if self.model is None:
                self.model = build_model(get_config(self.arch).replace(dtype="float32"))
                self.params = self.model.init(0, device=self.device)
            elif self.model.cfg.name != self.arch:
                raise ValueError(
                    f"bundle for arch {self.arch!r} given a {self.model.cfg.name!r} model"
                )
            elif self.params["embed"].device.type != self.device.type:
                raise ValueError(
                    f"bundle on {self.device} given parameters on {self.params['embed'].device}"
                )
            self.cfg = self.model.cfg
            self.built = True
        return self


def _group_prefix_tokens(group: str, n: int, vocab_size: int) -> List[int]:
    """The shared prompt template for a prefix group: deterministic in the
    group name alone (CRC32 seed, not Python's salted hash), so every twin
    of the same group starts with literally identical tokens across runs."""
    rng = np.random.default_rng(zlib.crc32(group.encode("utf-8")))
    return list(map(int, rng.integers(2, vocab_size, n)))


def to_engine_requests(
    reqs: Sequence[Request], hcfg: HarnessConfig, vocab_size: int, rng: np.random.Generator
) -> List[Tuple[Request, List[int]]]:
    """Map paper-scale requests onto engine-scale (Request, prompt) twins.

    Lengths are rescaled relative to the trace maximum (preserving relative
    ordering, so long-tail structure survives), arrivals are compressed by
    ``engine_arrival_scale``, tenant/SLO-class labels carry over unchanged,
    and the numeric SLO targets are compressed into engine virtual time
    (``engine_slo_ttft_scale`` / ``engine_slo_tpot_scale``) so relative
    tier tightness — premium vs batch — survives and attainment stays
    policy-sensitive rather than trivially 1.0.

    Requests carrying a ``prefix_group`` (shared-system-prompt scenarios)
    get prompts that literally begin with the group's template for
    ``prefix_frac`` of their length — the token-level structure the prefix
    cache and prefix-affinity routing act on.
    """
    if not reqs:
        return []
    max_in = max(r.input_len for r in reqs)
    max_out = max(r.output_len for r in reqs)
    pairs = []
    for r in reqs:
        n_in = 2 + round((hcfg.engine_max_prompt - 2) * r.input_len / max_in)
        n_out = max(1, round(hcfg.engine_max_output * r.output_len / max_out))
        if r.prefix_group:
            # template head + unique tail; at least one unique token so no
            # two prompts are fully identical
            k = min(n_in - 1, max(0, round(n_in * r.prefix_frac)))
            prompt = _group_prefix_tokens(r.prefix_group, k, vocab_size) + list(
                map(int, rng.integers(2, vocab_size, n_in - k))
            )
        else:
            prompt = list(map(int, rng.integers(2, vocab_size, n_in)))
        pairs.append(
            (
                Request(
                    rid=r.rid,
                    arrival=r.arrival * hcfg.engine_arrival_scale,
                    input_len=n_in,
                    output_len=n_out,
                    slo=SLOSpec(
                        ttft=r.slo.ttft * hcfg.slo_ttft_scale,
                        tpot=r.slo.tpot * hcfg.engine_slo_tpot_scale,
                    ),
                    tenant=r.tenant,
                    slo_class=r.slo_class,
                    prefix_group=r.prefix_group,
                    prefix_frac=r.prefix_frac,
                ),
                prompt,
            )
        )
    return pairs


def _cell_report(reqs: Sequence[Request]) -> Dict:
    """The backend-independent part of a cell: everything is derived from
    terminal request phases, so every backend emits an identical schema."""
    att = attainment(reqs).as_dict()
    per_tenant = {k: v.as_dict() for k, v in attainment_by(reqs, "tenant").items()}
    return dict(
        n_requests=len(reqs),
        n_completed=sum(r.phase == Phase.DONE for r in reqs),
        attainment=att,
        per_tenant=per_tenant,
        per_class={k: v.as_dict() for k, v in attainment_by(reqs, "slo_class").items()},
        goodput=goodput(reqs),
        # shed counts are the same n_shed the attainment rows carry — one
        # source of truth, surfaced where the CLI/CI consumers look for it
        shed=dict(
            total=att["n_shed"],
            by_tenant={k: v["n_shed"] for k, v in per_tenant.items() if v["n_shed"]},
        ),
        # client-withdrawn requests (async frontend disconnect / slow-consumer
        # shed); structurally parallel to `shed` but a different fate —
        # cancelled ≠ shed ≠ failed (sim.metrics module docstring)
        cancelled=dict(
            total=att["n_cancelled"],
            by_tenant={
                k: v["n_cancelled"] for k, v in per_tenant.items() if v["n_cancelled"]
            },
        ),
    )


def _run_sim(
    reqs, prefill: str, decode: str, hcfg: HarnessConfig,
    trace: Optional[TraceRecorder] = None,
) -> List[Request]:
    res = run_policy(reqs, prefill, decode, sim_cfg=hcfg.sim, trace=trace)
    return res.requests


def _engine_cfg(prefill: str, decode: str, hcfg: HarnessConfig):
    """The one `EngineConfig` every engine-family backend (and the churn
    backend's `server_factory` for scale-up replicas) builds from — keeping
    a cold-started replica's knobs identical to the seed fleet's."""
    from repro_torch.serving.engine import EngineConfig

    return EngineConfig(
        max_slots=hcfg.engine_max_slots,
        max_len=hcfg.engine_max_len,
        chunk_size=hcfg.engine_chunk_size,
        prefill_policy=prefill,
        decode_policy=decode,
        admission_queue_depth=hcfg.queue_depth,
        tenant_queue_depth=hcfg.tenant_quota,
        transfer_lat=hcfg.transfer_lat,
        transfer_bw=hcfg.transfer_bw,
        page_size=hcfg.page_size,
        cache_pages=hcfg.cache_pages,
    )


def _engine_setup(
    reqs,
    prefill: str,
    decode: str,
    hcfg: HarnessConfig,
    bundle: _EngineBundle,
    n_servers: int = 1,
    shared_clock: bool = False,
    trace: Optional[TraceRecorder] = None,
):
    """Shared (engine | async-engine | router | disagg | churn) setup:
    request twins plus ``n_servers`` fresh servers, each on its own
    deterministic ManualClock — or all on ONE shared clock
    (``shared_clock``, the disagg fleet's single-timeline requirement).
    Identical construction is what makes the engine backends directly
    comparable (and the 1-replica router cell bit-identical to
    async-engine).
    Returns ``(servers, pairs)``; single-server callers unpack ``servers[0]``.
    """
    from repro_torch.serving.clock import ManualClock
    from repro_torch.serving.engine import DisaggServer

    bundle.build()
    rng = np.random.default_rng(hcfg.seed)
    pairs = to_engine_requests(reqs, hcfg, bundle.cfg.vocab_size, rng)
    ecfg = _engine_cfg(prefill, decode, hcfg)
    fleet_clock = ManualClock(auto_step=1e-4) if shared_clock else None
    servers = [
        DisaggServer(
            bundle.model,
            bundle.params,
            ecfg,
            clock=fleet_clock if shared_clock else ManualClock(auto_step=1e-4),
            # server-level default sink, picked up by the single-server
            # sessions; the fleet backends instead hand the recorder to
            # their session layer (which stamps per-replica / per-pool
            # labels), so they build servers without one
            trace=trace,
            device=bundle.device,
        )
        for _ in range(n_servers)
    ]
    return servers, pairs


def _run_engine(
    reqs, prefill: str, decode: str, hcfg: HarnessConfig, bundle: _EngineBundle,
    trace: Optional[TraceRecorder] = None,
) -> Tuple[List[Request], Optional[Dict]]:
    from repro_torch.serving.session import ServeSession

    (server,), pairs = _engine_setup(reqs, prefill, decode, hcfg, bundle, trace=trace)
    session = ServeSession(server)
    session.run(pairs)
    return [r for r, _ in pairs], kv_cell_block(session.summary())


def _run_async_engine(
    reqs, prefill: str, decode: str, hcfg: HarnessConfig, bundle: _EngineBundle,
    trace: Optional[TraceRecorder] = None,
) -> Tuple[List[Request], Optional[Dict]]:
    """The live-concurrency cell: open-loop submission through the
    `AsyncServeSession` frontend, streams drained by concurrent clients."""
    import asyncio

    from repro_torch.serving.frontend import AsyncServeSession

    (server,), pairs = _engine_setup(reqs, prefill, decode, hcfg, bundle, trace=trace)

    async def _serve() -> Dict:
        frontend = AsyncServeSession(
            server,
            stream_buffer=hcfg.stream_buffer,
            backpressure=hcfg.backpressure,
        )
        async with frontend:
            await frontend.replay(pairs, clients=hcfg.async_clients)
        return frontend.summary()

    summary = asyncio.run(_serve())
    return [r for r, _ in pairs], kv_cell_block(summary)


def kv_cell_block(s: Dict) -> Optional[Dict]:
    """Project a session/fleet ``summary()`` into the report cell's ``kv``
    block: page-pool occupancy + sharing telemetry and the two sides of the
    reuse-is-real invariant (``prefill_computed_tokens`` must equal total
    prompt tokens minus ``prefix_cached_tokens`` — pinned in tests). None
    when the cell ran on the slot substrate (no ``pages`` in the summary),
    so slot cells keep their exact pre-paging schema."""
    if s.get("pages") is None:
        return None
    return dict(
        pages=s["pages"],
        prefix_cached_tokens=s["prefix_cached_tokens"],
        prefill_computed_tokens=s["prefill_computed_tokens"],
    )


def router_cell_block(s: Dict) -> Dict:
    """Project a `RouterSession.summary()` into the report cell's ``router``
    block: routing identity, fleet-wide prefix accounting, and per-replica
    counters (with the global/tenant shed split, so a per-tenant shed
    report can tell "fleet full" from "quota hit" per replica)."""
    return dict(
        policy=s["routing"]["policy"],
        replicas=s["routing"]["replicas"],
        assigned=s["routing"]["assigned"],
        prefix=s["prefix"],
        per_replica=[
            dict(
                replica=ps["replica"],
                assigned=ps["assigned"],
                submitted=ps["submitted"],
                completed=ps["completed"],
                rejected=ps["rejected"],
                rejected_global=ps["rejected_global"],
                rejected_tenant=ps["rejected_tenant"],
                cancelled=ps["cancelled"],
                prefix=ps["prefix"],
            )
            for ps in s["per_replica"]
        ],
    )


def _run_router(
    reqs, prefill: str, decode: str, hcfg: HarnessConfig, bundle: _EngineBundle,
    trace: Optional[TraceRecorder] = None,
) -> Tuple[List[Request], Dict]:
    """The fleet cell: ``router_replicas`` servers behind a `RouterSession`,
    placement by ``router_policy``. Returns the terminal requests plus the
    per-replica breakdown block for the report."""
    import asyncio

    from repro_torch.serving.router import RouterSession

    servers, pairs = _engine_setup(
        reqs, prefill, decode, hcfg, bundle, n_servers=hcfg.router_replicas
    )

    async def _serve() -> RouterSession:
        router = RouterSession(
            servers,
            policy=hcfg.router_policy,
            stream_buffer=hcfg.stream_buffer,
            backpressure=hcfg.backpressure,
            prefix_block=hcfg.prefix_block,
            prefix_cache_blocks=hcfg.prefix_cache_blocks,
            trace=trace,
        )
        async with router:
            await router.replay(pairs, clients=hcfg.async_clients)
        return router

    router = asyncio.run(_serve())
    return [r for r, _ in pairs], router_cell_block(router.summary())


def churn_cell_block(s: Dict) -> Dict:
    """Project a `FleetSession.summary()` into the report cell: the router
    block (the fleet IS a router) plus the ``fleet`` control-plane record —
    kills, restores, autoscale decisions, and the per-kill recovery plans."""
    return dict(router_cell_block(s), fleet=s["fleet"])


def _run_churn(
    reqs, prefill: str, decode: str, hcfg: HarnessConfig, bundle: _EngineBundle,
    trace: Optional[TraceRecorder] = None,
) -> Tuple[List[Request], Dict]:
    """The churn cell: ``router_replicas`` servers behind a `FleetSession`
    with the kill schedule from ``churn_kills`` injected mid-run and the
    registered ``autoscaler_policy`` moving the live-replica count on
    windowed-SLO telemetry. ``server_factory`` hands the controller
    identically-configured cold replicas for scale-up."""
    import asyncio

    from repro_torch.serving.clock import ManualClock
    from repro_torch.serving.engine import DisaggServer
    from repro_torch.serving.fleetctl import FleetSession

    servers, pairs = _engine_setup(
        reqs, prefill, decode, hcfg, bundle, n_servers=hcfg.router_replicas
    )

    def _factory() -> DisaggServer:
        return DisaggServer(
            bundle.model,
            bundle.params,
            _engine_cfg(prefill, decode, hcfg),
            clock=ManualClock(auto_step=1e-4),
            device=bundle.device,
        )

    async def _serve() -> FleetSession:
        fleet = FleetSession(
            servers,
            policy=hcfg.router_policy,
            autoscaler=hcfg.autoscaler_policy,
            n_min=hcfg.fleet_min_replicas,
            n_max=hcfg.fleet_max_replicas,
            autoscale_interval=hcfg.autoscale_interval,
            slo_window=hcfg.slo_window or hcfg.autoscale_interval or 0.5,
            kill_schedule=hcfg.churn_kills,
            server_factory=_factory,
            stream_buffer=hcfg.stream_buffer,
            backpressure=hcfg.backpressure,
            prefix_block=hcfg.prefix_block,
            prefix_cache_blocks=hcfg.prefix_cache_blocks,
            trace=trace,
        )
        async with fleet:
            await fleet.replay(pairs, clients=hcfg.async_clients)
        return fleet

    fleet = asyncio.run(_serve())
    return [r for r, _ in pairs], churn_cell_block(fleet.summary())


def disagg_cell_block(core, reqs: Sequence[Request]) -> Dict:
    """Project a `DisaggSession` into the report cell's ``disagg`` block:
    pool topology, the KV-handoff record, the deflection record, and the
    per-pool attainment split (which prefill worker's TTFT / which decode
    worker's TPOT story each pool tells)."""
    from repro_torch.sim.metrics import attainment_by_pool

    labels = core.pool_labels()
    return dict(
        pools=dict(prefill=len(core.prefill_pool), decode=len(core.decode_pool)),
        deflect=core.deflect.name,
        handoff=core.handoff_summary(),
        deflection=core.deflection_summary(),
        attainment_by_prefill_pool={
            k: v.as_dict()
            for k, v in attainment_by_pool(reqs, labels["prefill"]).items()
        },
        attainment_by_decode_pool={
            k: v.as_dict()
            for k, v in attainment_by_pool(reqs, labels["decode"]).items()
        },
    )


def _run_disagg(
    reqs, prefill: str, decode: str, hcfg: HarnessConfig, bundle: _EngineBundle,
    trace: Optional[TraceRecorder] = None,
) -> Tuple[List[Request], Dict, Optional[Dict]]:
    """The P/D-split cell: ``disagg_prefill``:``disagg_decode`` servers on
    ONE shared ManualClock behind a `DisaggFleetSession`, prefill deflection
    by ``deflect_policy``. Returns the terminal requests plus the report's
    ``disagg`` block."""
    import asyncio

    from repro_torch.serving.disagg import DisaggFleetSession

    servers, pairs = _engine_setup(
        reqs,
        prefill,
        decode,
        hcfg,
        bundle,
        n_servers=hcfg.disagg_prefill + hcfg.disagg_decode,
        shared_clock=True,
    )

    async def _serve() -> DisaggFleetSession:
        fleet = DisaggFleetSession(
            servers[: hcfg.disagg_prefill],
            servers[hcfg.disagg_prefill :],
            deflection=hcfg.deflect_policy,
            stream_buffer=hcfg.stream_buffer,
            backpressure=hcfg.backpressure,
            max_inflight_transfers=hcfg.max_inflight_transfers,
            trace=trace,
        )
        async with fleet:
            await fleet.replay(pairs, clients=hcfg.async_clients)
        return fleet

    fleet = asyncio.run(_serve())
    terminal = [r for r, _ in pairs]
    return terminal, disagg_cell_block(fleet.core, terminal), kv_cell_block(fleet.summary())


def _trace_path(base: str, scenario: str, prefill: str, decode: str, backend: str) -> str:
    """Per-cell trace path: the cell's coordinates spliced in before the
    extension, so one ``--trace out.json`` grid run never clobbers itself.
    The suffix is deterministic — consumers can reconstruct it, but the
    robust way is to read ``cell["trace"]["path"]`` from the report."""
    stem, dot, ext = base.rpartition(".")
    if not dot:
        stem, ext = base, "json"
    return f"{stem}.{backend}.{scenario}.{prefill}.{decode}.{ext}"


def evaluate_cell(
    scenario: str,
    prefill: str,
    decode: str,
    backend: str,
    hcfg: Optional[HarnessConfig] = None,
    scenario_kwargs: Optional[Dict] = None,
    _bundle: Optional[_EngineBundle] = None,
    device: DeviceLike = "cuda",
) -> Dict:
    """Run one (scenario, prefill, decode, backend) cell and report it.
    Engine-family backends serve on ``device`` (a given ``_bundle``'s
    must be the same); it raises without a card unless ``"cpu"``."""
    dev = resolve_device(device)
    if _bundle is not None and resolve_device(_bundle.device) != dev:
        raise ValueError(f"bundle on {_bundle.device}, cell on {dev}")
    if hcfg is None:
        hcfg = HarnessConfig()
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    kwargs = dict(scenario_kwargs or {})
    if hcfg.n_requests is not None:
        kwargs.setdefault("n_requests", hcfg.n_requests)
    # regenerate per cell so every cell is self-contained whatever the
    # backend does to the objects (the sim deepcopies and the engine builds
    # twins today, but a cell must not depend on its neighbors' backends)
    reqs = make_scenario(scenario, **kwargs).generate(hcfg.seed)
    if backend == "sim":
        bundle = None
    else:
        # build the model outside the timer; the kernels still build on
        # their first launch, so the first engine cell's wall_time_s on a
        # card carries that one-time cost
        bundle = (_bundle or _EngineBundle(hcfg.engine_arch, device=dev)).build()
    # wall_time_s is intentionally host wall-clock, not sim/engine virtual
    # time: it reports what the cell cost the machine (compile + compute),
    # never anything a scheduling decision reads
    t0 = time.perf_counter()  # repro: allow[RPA001] intentional host wall time
    router_block = None
    disagg_block = None
    churn_block = None
    kv_block = None
    # trace=None keeps every emission site on its `if recorder is None`
    # fast path — the traced and untraced runs are bit-identical either way
    # (pinned in tests), this just skips even the no-op checks
    recorder = TraceRecorder() if hcfg.trace is not None else None
    if backend == "sim":
        terminal = _run_sim(reqs, prefill, decode, hcfg, trace=recorder)
    elif backend == "engine":
        terminal, kv_block = _run_engine(reqs, prefill, decode, hcfg, bundle, trace=recorder)
    elif backend == "async-engine":
        terminal, kv_block = _run_async_engine(
            reqs, prefill, decode, hcfg, bundle, trace=recorder
        )
    elif backend == "disagg":
        terminal, disagg_block, kv_block = _run_disagg(
            reqs, prefill, decode, hcfg, bundle, trace=recorder
        )
    elif backend == "churn":
        terminal, churn_block = _run_churn(
            reqs, prefill, decode, hcfg, bundle, trace=recorder
        )
    else:
        terminal, router_block = _run_router(
            reqs, prefill, decode, hcfg, bundle, trace=recorder
        )
    cell = dict(
        scenario=scenario,
        prefill=prefill,
        decode=decode,
        backend=backend,
        wall_time_s=time.perf_counter() - t0,  # repro: allow[RPA001] see t0 above
    )
    cell.update(_cell_report(terminal))
    if hcfg.page_size is not None and backend != "sim":
        # bench cells carrying paged runs key separately from slot cells
        # (benchmarks/check_regression.py folds this into the cell key).
        # The sim backend never builds an engine, so page_size is inert
        # there and the cell keeps its slot identity.
        cell["variant"] = "paged"
    if kv_block is not None:
        cell["kv"] = kv_block
    if router_block is not None:
        cell["router"] = router_block
    if disagg_block is not None:
        cell["disagg"] = disagg_block
    if churn_block is not None:
        cell["churn"] = churn_block
    if recorder is not None:
        trace_block = trace_cell_block(recorder.events, slo_window=hcfg.slo_window)
        if hcfg.trace:  # "" = in-memory block only, no file
            path = _trace_path(hcfg.trace, scenario, prefill, decode, backend)
            trace_block["path"] = path
            trace_block["format"] = write_trace(recorder.events, path)
        cell["trace"] = trace_block
    return cell


def run_grid(
    scenarios: Sequence[str],
    prefills: Sequence[str],
    decodes: Sequence[str],
    backends: Sequence[str] = ("sim",),
    hcfg: Optional[HarnessConfig] = None,
    scenario_kwargs: Optional[Dict[str, Dict]] = None,
    device: DeviceLike = "cuda",
    bundle: Optional[_EngineBundle] = None,
) -> Dict:
    """Sweep the full cartesian grid; returns the single JSON-able report.

    ``scenario_kwargs`` maps scenario name -> factory kwargs (e.g. the
    ``replay`` scenario's ``path``). Engine-family cells serve on
    ``device`` with ``bundle``'s weights (default: built lazily from
    ``hcfg.engine_arch``, once for the grid).
    """
    if hcfg is None:
        hcfg = HarnessConfig()
    dev = resolve_device(device)
    if bundle is None:
        bundle = _EngineBundle(hcfg.engine_arch, device=dev)  # built lazily, shared by cells
    cells = []
    for backend in backends:
        for scenario in scenarios:
            for prefill in prefills:
                for decode in decodes:
                    cells.append(
                        evaluate_cell(
                            scenario,
                            prefill,
                            decode,
                            backend,
                            hcfg=hcfg,
                            scenario_kwargs=(scenario_kwargs or {}).get(scenario),
                            _bundle=bundle,
                            device=dev,
                        )
                    )
    return dict(
        grid=dict(
            scenarios=list(scenarios),
            prefills=list(prefills),
            decodes=list(decodes),
            backends=list(backends),
        ),
        config=hcfg.as_dict(),
        cells=cells,
    )
