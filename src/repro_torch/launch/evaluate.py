"""SLO-attainment evaluation CLI: scenario × policy × backend grids (a copy
of ``repro.launch.evaluate``; the engine-family backends serve through the
port's engine on ``--device``, default ``cuda``, and ``--device cpu`` runs
the plain path).

    PYTHONPATH=src python -m repro_torch.launch.evaluate \
        --scenario multi-tenant --backend engine \
        --prefill kairos-urgency --decode kairos-slack-greedy

Every flag that names a scenario/policy/backend accepts several values and
the harness sweeps the cartesian grid, emitting one JSON report (per-cell
total and per-tenant/per-class attainment, goodput, shed/cancelled counts)
to stdout or ``--out``. All six backends — ``sim``, ``engine``,
``async-engine`` (the `AsyncServeSession` frontend with concurrent stream
consumers; see `repro_torch.launch.loadgen` for the dedicated open-loop load generator),
``router`` (``--replicas`` frontends behind a `RouterSession`, placement by
``--router``, per-replica breakdown in the cell's ``router`` block), and
``disagg`` (a ``--pools P:D`` prefill/decode split with KV handoff and
``--deflect`` prefill deflection; handoff/deflection/per-pool-attainment in
the cell's ``disagg`` block), and ``churn`` (the router fleet under a
`FleetSession` control plane: ``--kill T:IDX`` replica-failure injection
with in-flight restore, ``--autoscaler`` elastic scaling on windowed-SLO
telemetry within ``--min-replicas``..``--max-replicas``; control-plane
record in the cell's ``churn`` block) — share the report schema;
``--list-scenarios`` / ``--list-policies`` print the registries.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.policies import (
    available_autoscaler_policies,
    available_deflection_policies,
    available_policies,
    available_router_policies,
)
from repro_torch.workloads.harness import (
    BACKENDS,
    HarnessConfig,
    parse_kills,
    parse_pools,
    run_grid,
)
from repro_torch.workloads.scenarios import available_scenarios


def build_parser() -> argparse.ArgumentParser:
    pol = available_policies()
    ap = argparse.ArgumentParser(
        description="Evaluate registered scheduling policies across workload "
        "scenarios on the simulator and/or the live engine."
    )
    ap.add_argument(
        "--scenario", nargs="+", default=["paper-longtail"], choices=available_scenarios(),
        help="workload scenario(s) from the repro_torch.workloads registry",
    )
    ap.add_argument(
        "--prefill", nargs="+", default=["kairos-urgency"], choices=pol["prefill"],
        help="prefill policy name(s) from the repro_torch.policies registry",
    )
    ap.add_argument(
        "--decode", nargs="+", default=["kairos-slack"], choices=pol["decode"],
        help="decode policy name(s) from the repro_torch.policies registry",
    )
    ap.add_argument(
        "--backend", nargs="+", default=["sim"], choices=BACKENDS,
        help="serving substrate(s): discrete-event sim and/or the live engine",
    )
    ap.add_argument("--n", type=int, default=64, help="requests per scenario")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--queue-depth", type=int, default=0,
        help="engine global admission queue depth; 0 = unbounded",
    )
    ap.add_argument(
        "--tenant-quota", type=int, default=0,
        help="engine per-tenant queued-request quota; 0 = no quota",
    )
    ap.add_argument(
        "--replay-trace", default=None,
        help='JSONL request-trace file for the "replay" scenario (input)',
    )
    ap.add_argument(
        "--trace", default=None, metavar="PATH",
        help="write a per-cell event trace (repro_torch.obs): .jsonl = raw event "
        "log, anything else = Chrome trace-event / Perfetto JSON; the cell "
        "coordinates are spliced into the filename and each cell carries a "
        '"trace" summary block in the report',
    )
    ap.add_argument(
        "--slo-window", type=float, default=None, metavar="SECONDS",
        help="with --trace: windowed SLO telemetry bucket width in backend "
        "virtual seconds (adds a windows series to each trace block)",
    )
    ap.add_argument(
        "--clients", type=int, default=4,
        help="async-engine backend: concurrent stream-consumer tasks",
    )
    ap.add_argument(
        "--stream-buffer", type=int, default=16,
        help="async-engine backend: per-request token buffer size",
    )
    ap.add_argument(
        "--backpressure", default="block", choices=("block", "shed"),
        help="async-engine backend: slow-consumer policy (block the engine "
        "or shed the laggard's request)",
    )
    ap.add_argument(
        "--arrival-scale", type=float, default=0.01,
        help="engine backend: arrivals are multiplied by this (engine virtual "
        "seconds per trace second; 0.01 compresses the trace 100x)",
    )
    ap.add_argument(
        "--replicas", type=int, default=2,
        help="router backend: AsyncServeSession replica count",
    )
    ap.add_argument(
        "--router", default="least-queued", choices=available_router_policies(),
        help="router backend: routing policy from the repro_torch.policies registry",
    )
    ap.add_argument(
        "--pools", default="2:2", type=parse_pools, metavar="P:D",
        help="disagg backend: prefill:decode pool sizes (e.g. 2:2)",
    )
    ap.add_argument(
        "--deflect", default="never", choices=available_deflection_policies(),
        help="disagg backend: prefill-deflection policy from the registry",
    )
    ap.add_argument(
        "--kill", action="append", default=None, metavar="T:IDX",
        help="churn backend: kill replica IDX at fleet virtual time T "
        "(repeatable; in-flight requests restore onto survivors)",
    )
    ap.add_argument(
        "--autoscaler", default="static", choices=available_autoscaler_policies(),
        help="churn backend: autoscaler policy from the repro_torch.policies registry",
    )
    ap.add_argument(
        "--autoscale-interval", type=float, default=0.05,
        help="churn backend: autoscaler evaluation period in fleet virtual "
        "seconds (also the windowed-SLO bucket width when --slo-window is "
        "not given)",
    )
    ap.add_argument(
        "--min-replicas", type=int, default=1,
        help="churn backend: autoscaler floor on live replicas",
    )
    ap.add_argument(
        "--max-replicas", type=int, default=6,
        help="churn backend: autoscaler ceiling on live replicas",
    )
    ap.add_argument(
        "--page-size", type=int, default=0,
        help="engine-family backends: tokens per KV page; >0 switches the "
        "decode engines from contiguous slot KV to refcounted pages with "
        "radix prefix reuse (DESIGN.md §kvcache); 0 keeps the slot substrate",
    )
    ap.add_argument(
        "--cache-pages", type=int, default=0,
        help="with --page-size: total pages in the KV pool (0 = the "
        "slot-equivalent max_slots * max_len / page_size)",
    )
    ap.add_argument(
        "--transfer-bw", type=float, default=900e9,
        help="KV handoff bandwidth in bytes/sec (engine admission + disagg "
        "cross-server transfers, priced via CostModel.transfer_time)",
    )
    ap.add_argument(
        "--transfer-lat", type=float, default=0.002,
        help="KV handoff fixed latency in virtual seconds",
    )
    ap.add_argument("--out", default=None, help="write the JSON report here (default stdout)")
    ap.add_argument(
        "--device", default="cuda",
        help="device the engine-family backends run on: cuda (default; raises "
        "without a card) or cpu",
    )
    ap.add_argument("--list-scenarios", action="store_true")
    ap.add_argument("--list-policies", action="store_true")
    return ap


def main(argv: Optional[List[str]] = None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)

    if args.list_scenarios:
        print("scenarios:", ", ".join(available_scenarios()))
        return {}
    if args.list_policies:
        for side, names in available_policies().items():
            print(f"{side}: {', '.join(names)}")
        return {}

    scenario_kwargs = {}
    if "replay" in args.scenario:
        if args.replay_trace is None:
            ap.error('the "replay" scenario requires --replay-trace <file.jsonl>')
        scenario_kwargs["replay"] = {"path": args.replay_trace}

    hcfg = HarnessConfig(
        n_requests=args.n,
        seed=args.seed,
        queue_depth=args.queue_depth or None,
        tenant_quota=args.tenant_quota or None,
        engine_arrival_scale=args.arrival_scale,
        async_clients=args.clients,
        stream_buffer=args.stream_buffer,
        backpressure=args.backpressure,
        router_replicas=args.replicas,
        router_policy=args.router,
        disagg_prefill=args.pools[0],
        disagg_decode=args.pools[1],
        deflect_policy=args.deflect,
        churn_kills=parse_kills(args.kill or ()),
        autoscaler_policy=args.autoscaler,
        autoscale_interval=args.autoscale_interval,
        fleet_min_replicas=args.min_replicas,
        fleet_max_replicas=args.max_replicas,
        transfer_bw=args.transfer_bw,
        transfer_lat=args.transfer_lat,
        page_size=args.page_size or None,
        cache_pages=args.cache_pages or None,
        trace=args.trace,
        slo_window=args.slo_window,
    )
    report = run_grid(
        scenarios=args.scenario,
        prefills=args.prefill,
        decodes=args.decode,
        backends=args.backend,
        hcfg=hcfg,
        scenario_kwargs=scenario_kwargs,
        device=args.device,
    )
    text = json.dumps(report, indent=2, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        ncells = len(report["cells"])
        print(f"wrote {ncells} cells to {args.out}", file=sys.stderr)
    else:
        print(text)
    return report


if __name__ == "__main__":
    main()
