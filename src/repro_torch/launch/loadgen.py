"""Open-loop async load generator: live clients against the serving engine
(a copy of ``repro.launch.loadgen``, serving through the port's engine on
``--device``, default ``cuda``; ``--device cpu`` runs the plain path).

    PYTHONPATH=src python -m repro_torch.launch.loadgen \
        --scenario bursty --clients 8 \
        --prefill kairos-urgency --decode kairos-slack

Replays any registered `repro_torch.workloads` scenario against a live
`DisaggServer` through the `AsyncServeSession` frontend: every request is
submitted at its arrival time regardless of how the previous ones are doing
(open loop — the load does not back off when the server struggles), and the
resulting token streams are drained by ``--clients`` concurrent consumer
tasks. This is the online counterpart of ``launch/evaluate.py``'s replayed
backends, and it emits the *same* JSON report schema (one ``async-engine``
cell inside the usual grid envelope), so the analysis/plotting
tooling consumes loadgen output unchanged. The cell carries one extra
``loadgen`` block: per-client token counts, the backpressure policy, and
whether the run used the wall clock.

By default the run is driven on a deterministic `ManualClock` (virtual
time, reproducible, fast); ``--realtime`` switches to the wall clock for a
true online measurement where consumer latency and engine step time
genuinely overlap.

``--servers N --router <policy>`` serves through a `RouterSession` fleet
instead of a single frontend: N replica engines, placement by a registered
routing policy (round-robin / least-queued / slack-aware / prefix-affinity),
and a ``router`` block in the cell with per-replica request counts and
prefix-cache hit rates.

``--pools P:D`` serves through a disaggregated `DisaggFleetSession` instead:
P prefill + D decode servers on one shared clock, cross-pool KV handoff
priced by the calibrated cost model, prefill deflection by ``--deflect``,
and the same ``disagg`` cell block ``launch/evaluate.py`` emits (handoff and
deflection records, per-pool attainment).
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import sys
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.policies import (
    available_deflection_policies,
    available_policies,
    available_router_policies,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import TraceRecorder, trace_cell_block, write_trace
from repro_torch.workloads.harness import (
    HarnessConfig,
    _cell_report,
    _EngineBundle,
    _engine_setup,
    _trace_path,
    disagg_cell_block,
    kv_cell_block,
    parse_pools,
    router_cell_block,
)
from repro_torch.workloads.scenarios import available_scenarios, make_scenario


def run_loadgen(
    scenario: str,
    prefill: str,
    decode: str,
    hcfg: HarnessConfig,
    realtime: bool = False,
    scenario_kwargs: Optional[Dict] = None,
    servers: int = 1,
    router: Optional[str] = None,
    pools: Optional[Tuple[int, int]] = None,
    device: DeviceLike = "cuda",
    bundle: Optional[_EngineBundle] = None,
) -> Dict:
    """One open-loop cell wrapped in the evaluate.py schema: a single
    ``async-engine`` frontend by default, a routed fleet (`RouterSession`,
    per-replica ``router`` block) with ``servers > 1`` or an explicit
    ``router`` policy, or a disaggregated P:D fleet (`DisaggFleetSession`,
    ``disagg`` block) with ``pools``. The servers run on ``device`` with
    ``bundle``'s weights (default: built from ``hcfg.engine_arch``)."""
    from repro_torch.serving.clock import MonotonicClock
    from repro_torch.serving.disagg import DisaggFleetSession
    from repro_torch.serving.frontend import AsyncServeSession
    from repro_torch.serving.router import RouterSession

    dev = resolve_device(device)
    if bundle is None:
        bundle = _EngineBundle(hcfg.engine_arch, device=dev)
    elif resolve_device(bundle.device) != dev:
        raise ValueError(f"bundle on {bundle.device}, loadgen on {dev}")
    routed = servers > 1 or router is not None
    disagg = pools is not None
    if routed and disagg:
        raise ValueError("--pools (disagg) and --servers/--router are exclusive")
    if routed:
        hcfg = dataclasses.replace(
            hcfg,
            router_replicas=max(1, servers),
            router_policy=router or hcfg.router_policy,
        )
    if disagg:
        hcfg = dataclasses.replace(
            hcfg, disagg_prefill=pools[0], disagg_decode=pools[1]
        )
    kwargs = dict(scenario_kwargs or {})
    if hcfg.n_requests is not None:
        kwargs.setdefault("n_requests", hcfg.n_requests)
    reqs = make_scenario(scenario, **kwargs).generate(hcfg.seed)
    n_servers = 1
    if routed:
        n_servers = hcfg.router_replicas
    elif disagg:
        n_servers = hcfg.disagg_prefill + hcfg.disagg_decode
    fleet, pairs = _engine_setup(
        reqs, prefill, decode, hcfg, bundle,
        n_servers=n_servers, shared_clock=disagg,
    )
    if realtime:
        # the disagg fleet must keep sharing ONE clock instance even on the
        # wall clock — per-server clocks fail _FleetClock's validation
        wall_clock = MonotonicClock()
        for srv in fleet:
            srv.clock = wall_clock if disagg else MonotonicClock()
    clients = max(1, hcfg.async_clients)
    # same contract as the harness: None keeps every emission site on its
    # fast path; "" records in memory without writing a file
    recorder = TraceRecorder() if hcfg.trace is not None else None

    async def _serve():
        # the open-loop drive is (Async|Router|DisaggFleet)Session.replay —
        # the same code paths as the harness's engine backends — with a
        # hook for the per-client accounting this report adds
        counts = [0] * clients
        on_tok = lambda c, _tok: counts.__setitem__(c, counts[c] + 1)
        if routed:
            session = RouterSession(
                fleet,
                policy=hcfg.router_policy,
                stream_buffer=hcfg.stream_buffer,
                backpressure=hcfg.backpressure,
                prefix_block=hcfg.prefix_block,
                prefix_cache_blocks=hcfg.prefix_cache_blocks,
                trace=recorder,
            )
        elif disagg:
            session = DisaggFleetSession(
                fleet[: hcfg.disagg_prefill],
                fleet[hcfg.disagg_prefill :],
                deflection=hcfg.deflect_policy,
                stream_buffer=hcfg.stream_buffer,
                backpressure=hcfg.backpressure,
                max_inflight_transfers=hcfg.max_inflight_transfers,
                trace=recorder,
            )
        else:
            session = AsyncServeSession(
                fleet[0],
                stream_buffer=hcfg.stream_buffer,
                backpressure=hcfg.backpressure,
                trace=recorder,
            )
        async with session:
            await session.replay(pairs, clients=clients, on_client_token=on_tok)
        return counts, session

    t0 = time.perf_counter()
    tokens_by_client, session = asyncio.run(_serve())
    wall = time.perf_counter() - t0

    backend = "router" if routed else ("disagg" if disagg else "async-engine")
    cell = dict(
        scenario=scenario,
        prefill=prefill,
        decode=decode,
        backend=backend,
        wall_time_s=wall,
    )
    cell.update(_cell_report([r for r, _ in pairs]))
    cell["loadgen"] = dict(
        clients=clients,
        realtime=realtime,
        tokens_by_client=tokens_by_client,
        backpressure=hcfg.backpressure,
        stream_buffer=hcfg.stream_buffer,
    )
    if hcfg.page_size is not None:
        cell["variant"] = "paged"
    kv_block = kv_cell_block(session.summary())
    if kv_block is not None:
        cell["kv"] = kv_block
    if routed:
        cell["router"] = router_cell_block(session.summary())
    if disagg:
        cell["disagg"] = disagg_cell_block(session.core, [r for r, _ in pairs])
    if recorder is not None:
        trace_block = trace_cell_block(recorder.events, slo_window=hcfg.slo_window)
        if hcfg.trace:
            path = _trace_path(hcfg.trace, scenario, prefill, decode, backend)
            trace_block["path"] = path
            trace_block["format"] = write_trace(recorder.events, path, recorder.spans)
        cell["trace"] = trace_block
    return dict(
        grid=dict(
            scenarios=[scenario],
            prefills=[prefill],
            decodes=[decode],
            backends=[backend],
        ),
        config=hcfg.as_dict(),
        cells=[cell],
    )


def build_parser() -> argparse.ArgumentParser:
    pol = available_policies()
    ap = argparse.ArgumentParser(
        description="Open-loop async load generator over the live engine "
        "(AsyncServeSession frontend)."
    )
    ap.add_argument(
        "--scenario", default="paper-longtail", choices=available_scenarios(),
        help="workload scenario from the repro_torch.workloads registry",
    )
    ap.add_argument("--prefill", default="kairos-urgency", choices=pol["prefill"])
    ap.add_argument("--decode", default="kairos-slack", choices=pol["decode"])
    ap.add_argument(
        "--servers", type=int, default=1,
        help="replica count: >1 serves through a RouterSession fleet",
    )
    ap.add_argument(
        "--router", default=None, choices=available_router_policies(),
        help="routing policy (implies the routed path even with --servers 1)",
    )
    ap.add_argument(
        "--pools", default=None, type=parse_pools, metavar="P:D",
        help="serve through a disaggregated prefill:decode fleet "
        "(DisaggFleetSession) instead of a single frontend",
    )
    ap.add_argument(
        "--deflect", default="never", choices=available_deflection_policies(),
        help="disagg fleet: prefill-deflection policy from the registry",
    )
    ap.add_argument(
        "--page-size", type=int, default=0,
        help="tokens per KV page; >0 switches the decode engines to paged "
        "KV with radix prefix reuse (DESIGN.md §kvcache); 0 = slot KV",
    )
    ap.add_argument(
        "--cache-pages", type=int, default=0,
        help="with --page-size: total pages in the KV pool (0 = the "
        "slot-equivalent max_slots * max_len / page_size)",
    )
    ap.add_argument(
        "--transfer-bw", type=float, default=900e9,
        help="KV handoff bandwidth in bytes/sec (priced via CostModel.transfer_time)",
    )
    ap.add_argument(
        "--transfer-lat", type=float, default=0.002,
        help="KV handoff fixed latency in virtual seconds",
    )
    ap.add_argument("--clients", type=int, default=4, help="concurrent consumer tasks")
    ap.add_argument("--n", type=int, default=64, help="requests in the scenario")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--queue-depth", type=int, default=0,
        help="global admission queue depth; 0 = unbounded",
    )
    ap.add_argument(
        "--tenant-quota", type=int, default=0,
        help="per-tenant queued-request quota; 0 = no quota",
    )
    ap.add_argument(
        "--arrival-scale", type=float, default=0.01,
        help="arrivals are multiplied by this (virtual seconds per trace second)",
    )
    ap.add_argument(
        "--stream-buffer", type=int, default=16,
        help="per-request token buffer before backpressure applies",
    )
    ap.add_argument(
        "--backpressure", default="block", choices=("block", "shed"),
        help="slow-consumer policy: stall the engine, or cancel the laggard",
    )
    ap.add_argument(
        "--realtime", action="store_true",
        help="drive the engine on the wall clock instead of virtual time",
    )
    ap.add_argument(
        "--replay-trace", default=None,
        help='JSONL request-trace file for the "replay" scenario (input)',
    )
    ap.add_argument(
        "--trace", default=None, metavar="PATH",
        help="write an event trace of the run (repro_torch.obs): .jsonl = raw "
        "event log, anything else = Chrome trace-event / Perfetto JSON; "
        'the cell gains a "trace" summary block',
    )
    ap.add_argument(
        "--slo-window", type=float, default=None, metavar="SECONDS",
        help="with --trace: windowed SLO telemetry bucket width in virtual "
        "(or, with --realtime, wall) seconds",
    )
    ap.add_argument("--out", default=None, help="write the JSON report here (default stdout)")
    ap.add_argument(
        "--device", default="cuda",
        help="device the engines run on: cuda (default; raises without a card) or cpu",
    )
    return ap


def main(argv: Optional[List[str]] = None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    scenario_kwargs = None
    if args.scenario == "replay":
        if args.replay_trace is None:
            ap.error('the "replay" scenario requires --replay-trace <file.jsonl>')
        scenario_kwargs = {"path": args.replay_trace}

    if args.pools is not None and (args.servers > 1 or args.router is not None):
        ap.error("--pools (disagg) and --servers/--router are mutually exclusive")

    hcfg = HarnessConfig(
        n_requests=args.n,
        seed=args.seed,
        queue_depth=args.queue_depth or None,
        tenant_quota=args.tenant_quota or None,
        engine_arrival_scale=args.arrival_scale,
        async_clients=args.clients,
        stream_buffer=args.stream_buffer,
        backpressure=args.backpressure,
        deflect_policy=args.deflect,
        transfer_bw=args.transfer_bw,
        transfer_lat=args.transfer_lat,
        page_size=args.page_size or None,
        cache_pages=args.cache_pages or None,
        trace=args.trace,
        slo_window=args.slo_window,
    )
    report = run_loadgen(
        args.scenario, args.prefill, args.decode, hcfg,
        realtime=args.realtime, scenario_kwargs=scenario_kwargs,
        servers=args.servers, router=args.router, pools=args.pools,
        device=args.device,
    )
    text = json.dumps(report, indent=2, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        cell = report["cells"][0]
        print(
            f"loadgen: {cell['n_completed']}/{cell['n_requests']} completed, "
            f"{sum(cell['loadgen']['tokens_by_client'])} tokens streamed by "
            f"{cell['loadgen']['clients']} clients -> {args.out}",
            file=sys.stderr,
        )
    else:
        print(text)
    return report


if __name__ == "__main__":
    main()
