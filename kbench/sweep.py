"""Find an open-loop cell's knee: serve its traffic at several rates in one
process (weights and warm-up once) and print, per rate, the backlog
(prefill queue + waiting handoffs) at the window's middle and end, the
tails and the peak memory. The knee is the highest rate whose backlog at
the end is no longer than at the middle; the cell's traffic file then
states 0.8 of it.

    python3 kbench/sweep.py --workload <name> --rates 0.3,0.4,0.5 --seconds 51 [--seed n]
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from kbench.run import prepare

    prepare()
    import torch

    from kbench import bench
    from kbench.spec import load_cell, reader
    from kbench.traffic.generator import Mix
    from kbench.weights import make_weights
    from repro_torch.models import build_model
    from repro_torch.serving.engine import DisaggServer

    cell = load_cell(json.loads((ROOT / "BENCHMARK.json").read_text()), args.workload)
    dev = torch.device("cuda")
    cfg = cell.config
    mcfg = bench.model_config(cfg)
    model = build_model(mcfg)
    weights = make_weights(model.param_struct(), args.seed, dev)
    server = DisaggServer(model, weights, bench.engine_config(cfg), device=dev)
    spans = bench.Spans(server, labelled=False)
    bench.warm_up(server, mcfg.vocab_size)
    for rate in (float(r) for r in args.rates.split(",")):
        mix = Mix(cell.mix.name, dict(cell.mix.params, rate=rate))
        c = dataclasses.replace(cell, mix=mix)
        reqs = mix.draw(args.seed, args.seconds, cfg["max_len"], mcfg.vocab_size)
        spans.prefill.clear()
        spans.decode.clear()
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.monotonic()
        out = asyncio.run(bench._drive(server, c, reqs, args.seconds, False, spans))
        rec = dict(window=(mix.lead_in_s, mix.lead_in_s + args.seconds),
                   rows=list(out["rows"].values()), prefill_spans=spans.prefill,
                   decode_spans=spans.decode, steps=[], model=cfg, setup_s=0.0, profile=None)
        vals = {m: reader(m)(rec) for m in ("ttft_p50_s", "tpot_p95_ms", "output_tokens_per_s",
                                           "prefill_ms_per_ktok", "mfu.prefill", "mfu.decode")}
        n_due = sum(rec["window"][0] <= r["due"] < rec["window"][1] for r in rec["rows"])
        print(f"[sweep] {args.workload} rate {rate}: backlog mid {out['backlog'].get('mid')} end "
              f"{out['backlog'].get('end')}; due in window {n_due}; finished {len(out['done'])}; "
              f"{vals}; peak {torch.cuda.max_memory_allocated(dev)} B; "
              f"{time.monotonic() - t:.1f} s", flush=True)
        server.reset_for_restart()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
