"""Run one cell of the benchmark once and print its result line.

    python3 kbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout (it reads ``BENCHMARK.json`` there and
imports the port from ``src/``). Needs as many CUDA cards as the cell asks
for; without them it exits with code 2 and prints no result. The last line
of standard output is the result object; the numbers the correctness check
compared are the last lines of standard error and the result's last key.
Kernel builds go to ``build/repro_torch/`` inside the checkout.
"""
from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # whole top-level module names


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def prepare() -> None:
    """Environment of a run, set before torch is imported: the caches
    inside the checkout at fixed paths, and the port on the path."""
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "repro_torch")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    prepare()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    import torch

    from kbench.bench import run_cell
    from kbench.spec import load_cell

    cell = load_cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"kbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"kbench: the run loaded forbidden modules: {bad}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    checks = result["checks"]
    print("kbench compared: " + "; ".join(
        f"{k} {v['value']!r} limit {v['limit']!r}" for k, v in checks.items()),
        file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
