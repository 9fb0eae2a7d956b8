"""The correctness check's two readings for one cell, on the chip at the
cell's own size and load, many seeds in one process: for each seed a run
of the cell (``--seconds`` of window after its lead-in), then the widest
logit gap of what the program served (the lower reading is the largest
over the seeds) and of what the float8 control (the reference the
configuration names, ``kbench/reference/<reference>.py``, at
``quant="fp8"``) puts first at the same positions (the upper reading is
the smallest). The benchmark's own runs do not run the control.

    python3 kbench/control.py --workload <name> --seeds 11,12,13 --seconds 20
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20)
    ap.add_argument("--quant", default="fp8", help="comma-separated: fp8 (the control), "
                    "bf16 (a witness of rounding alone)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from kbench.run import prepare

    prepare()
    from kbench.bench import run_cell
    from kbench.spec import load_cell

    cell = load_cell(json.loads((ROOT / "BENCHMARK.json").read_text()), args.workload)
    quants = tuple(args.quant.split(","))
    widest = {q: [] for q in ("program",) + quants}
    mean = {q: [] for q in ("program",) + quants}
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run_cell(cell, seed, args.seconds, False, time.monotonic(), control=quants)
        c = r["_check"]
        for q, g in c["readings"].items():
            widest[q].append(float(g.max()))
            mean[q].append(float(g.mean()))
            print(f"[control] {args.workload} seed {seed} {q}: widest gap {g.max()!r}, mean "
                  f"{g.mean()!r}, 99th percentile {np.percentile(g, 99)!r}, not the "
                  f"reference's first {(g > 0).mean()!r} of {g.size} tokens", flush=True)
    for q in widest:
        for name, v in (("widest", widest[q]), ("mean", mean[q])):
            print(f"[control] {args.workload} {q}: {name} gap max {max(v)!r} min {min(v)!r} "
                  f"over {len(v)} seeds {v}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
