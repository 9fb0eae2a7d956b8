"""Training launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b-smoke \\
        --steps 100 --batch 8 --seq 256 [--n-micro 2] [--ckpt-dir DIR] [--device cpu]

``--device`` defaults to ``cuda`` and fails without a card (``--device cpu``
trains on the plain path on the CPU). Weights are random, drawn from seed 0
in the config's dtype. With ``--ckpt-dir`` a run resumes from the newest
checkpoint there (the reference's on-disk format), saves every
``--ckpt-every`` steps on a background thread and once at the end. On the
card the dense families train whole at their published widths, e.g.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
        --steps 6 --batch 8 --seq 2048 --n-micro 2
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import build_model
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import DataConfig, SyntheticDataset
from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
from repro_torch.training.train_step import make_train_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Training on PyTorch")
    ap.add_argument("--arch", default="llama3-8b-smoke")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    model = build_model(cfg)
    print(f"arch={cfg.name} params={cfg.count_params():,} device={dev}")

    opt_cfg = OptimizerConfig(
        lr=args.lr,
        warmup_steps=max(2, args.steps // 10),
        stable_steps=args.steps,
        decay_steps=max(1, args.steps // 10),
    )
    ds = SyntheticDataset(cfg, DataConfig(seq_len=args.seq, global_batch=args.batch))
    step_fn = make_train_step(model, opt_cfg, n_micro=args.n_micro)

    ck = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    params = model.init(0, device=dev)
    opt = init_opt_state(params)
    start = 0
    if ck is not None and ck.latest_step() is not None:
        restored, start = ck.restore({"params": params, "opt": opt})
        params, opt = restored["params"], restored["opt"]
        print(f"resumed at step {start}")

    t0 = time.time()
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in ds.batch_at(step).items()}
        params, opt, m = step_fn(params, opt, batch)
        if step % 10 == 0 or step == args.steps - 1:
            synchronize(dev)
            print(
                f"step {step:5d} loss={float(m['loss']):.4f} lr={float(m['lr']):.2e} "
                f"gnorm={float(m['grad_norm']):.2f} {(time.time() - t0):.0f}s",
                flush=True,
            )
        if ck is not None and step and step % args.ckpt_every == 0:
            ck.save(step, {"params": params, "opt": opt}, async_=True)
    if ck is not None:
        ck.save(args.steps, {"params": params, "opt": opt})


if __name__ == "__main__":
    main()
