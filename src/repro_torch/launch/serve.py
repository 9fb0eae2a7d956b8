"""Serving launcher: the disaggregated engine on PyTorch with
registry-driven scheduling (port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \\
        --arch llama3-8b-smoke --requests 8 [--policy kairos-urgency] \\
        [--decode-policy kairos-slack] [--dtype float32] [--queue-depth 16]

``--device`` defaults to ``cuda`` and fails without a card (``--device cpu``
runs the plain path on the CPU); ``--dtype`` defaults to the config's own.
Weights are random, drawn from ``--seed``. Every attention family serves
through ``--arch`` (dense, moe, vlm on tokens):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3.5-moe-42b-a6.6b-smoke

(phi3.5-moe-42b-a6.6b itself takes about 84 GB in bf16, more than one
80 GB card holds.)

The engine decodes into lanes of 128 positions, so an alternating
local/global model with a window under 128 (``gemma2-9b-smoke``: 32) is
refused (ROADMAP C6).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.request import Request, SLOSpec
from repro_torch.models import build_model
from repro_torch.policies import available_policies
from repro_torch.serving.engine import DisaggServer, EngineConfig
from repro_torch.serving.session import ServeSession


def main(argv=None) -> None:
    pol = available_policies()
    ap = argparse.ArgumentParser(description="Disaggregated serving demo on PyTorch")
    ap.add_argument("--arch", default="llama3-8b-smoke")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                    help="weight/activation dtype; default: the config's own")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-out", type=int, default=12)
    ap.add_argument("--policy", default="kairos-urgency", choices=pol["prefill"],
                    help=f"prefill policy; registered: {', '.join(pol['prefill'])}")
    ap.add_argument("--decode-policy", default="kairos-slack", choices=pol["decode"],
                    help=f"decode policy; registered: {', '.join(pol['decode'])}")
    ap.add_argument("--queue-depth", type=int, default=0,
                    help="admission-control queue depth; 0 = unbounded")
    ap.add_argument("--list-policies", action="store_true",
                    help="print registered policies and exit")
    ap.add_argument("--chunk-size", type=int, default=16)
    ap.add_argument("--ttft-slo", type=float, default=60.0)
    ap.add_argument("--tpot-slo", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.list_policies:
        for side, names in pol.items():
            print(f"{side}: {', '.join(names)}")
        return

    cfg = get_config(args.arch)
    if args.dtype is not None:
        cfg = cfg.replace(dtype=args.dtype)
    model = build_model(cfg)
    params = model.init(args.seed, device=args.device)
    rng = np.random.default_rng(args.seed)

    reqs = []
    for i in range(args.requests):
        n = int(rng.choice([6, 10, 16, 40], p=[0.4, 0.3, 0.2, 0.1]))
        prompt = list(map(int, rng.integers(2, cfg.vocab_size, n)))
        reqs.append(
            (
                Request(rid=i, arrival=0.05 * i, input_len=n, output_len=args.max_out,
                        slo=SLOSpec(ttft=args.ttft_slo, tpot=args.tpot_slo)),
                prompt,
            )
        )

    ecfg = EngineConfig(
        max_slots=8, max_len=128, chunk_size=args.chunk_size,
        prefill_policy=args.policy, decode_policy=args.decode_policy,
        admission_queue_depth=args.queue_depth or None,
    )
    server = DisaggServer(model, params, ecfg, device=args.device)

    # drive the streaming session directly (what serve() wraps) so the
    # admission metrics stay in hand
    session = ServeSession(server)
    outs = session.run(reqs)
    n_ok = 0
    for r, _ in reqs:
        ok = r.meets_e2e()
        n_ok += ok
        print(
            f"rid={r.rid} phase={r.phase.value} tokens={len(outs.get(r.rid, []))} "
            f"ttft={(r.ttft() or 0):.3f}s mean_itl={1e3*(r.mean_tpot() or 0):.1f}ms e2e_ok={ok}"
        )
    s = session.summary()
    print(
        f"E2E SLO attainment: {n_ok}/{len(reqs)} "
        f"(submitted={s['submitted']} shed={s['rejected']}) on {server.device}"
    )


if __name__ == "__main__":
    main()
