"""Roofline report over every (arch x shape) cell at full size (port of
``repro.roofline.report``).

The reference reads dry-run artifacts (compiled HLO of each cell on its
TPU mesh). Here each cell of ``ASSIGNED x ALL_SHAPES`` is built at full
size on meta tensors (`Model.param_struct` plus `configs.shapes.
input_specs`: nothing is allocated) and its unsharded step is counted with
`op_stats`: `Model.prefill`, `Model.decode` of one token, or the training
step at `default_microbatches`. Each cell's `RooflineTerms` are for
``chips`` H100s sharing the step evenly (default 8, one HGX/DGX H100), with
no collective, so the collective term is 0; `launch.dryrun` counts the
same steps placed on a production mesh, collectives included. "HBM/chip" is the bytes of the
parameters, inputs and cache over ``chips``: no optimizer state and no
activations, so a lower bound.

    PYTHONPATH=src python -m repro_torch.roofline.report [--chips 8]

runs on the CPU with no card.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from repro_torch.configs import ALL_SHAPES, ASSIGNED, ModelConfig, get_config
from repro_torch.configs.shapes import ShapeSpec, input_specs, shape_applicable
from repro_torch.models import build_model
from repro_torch.roofline import op_stats
from repro_torch.roofline.analysis import (
    RooflineTerms,
    analytic_memory_bytes,
    model_flops_for,
)
from repro_torch.roofline.hw import H100
from repro_torch.training.optimizer import OptimizerConfig, init_opt_state, tree_leaves
from repro_torch.training.train_step import default_microbatches, make_train_step


@dataclass
class Cell:
    arch: str
    shape: str
    terms: Optional[RooflineTerms]  # None: skipped
    hbm_bytes_per_chip: float = 0.0
    reason: str = ""


def step_stats(cfg: ModelConfig, spec: ShapeSpec, params: Dict, inputs: Dict,
               n_micro: Optional[int] = None) -> op_stats.OpStats:
    """The op count of ``spec``'s step of ``cfg`` on ``params`` and
    ``inputs`` (`input_specs`' tree, on any device), a training step at
    ``n_micro`` microbatches (`default_microbatches` where None): the
    attention takes the kernels' wrappers on every device
    (``attn_impl="pallas"``, which on the card is the path "auto" takes)."""
    model = build_model(cfg.replace(attn_impl="pallas"))
    if spec.kind == "prefill":
        return op_stats.count(model.prefill, params, inputs)
    if spec.kind == "decode":
        return op_stats.count(model.decode, params, inputs["tokens"], inputs["positions"],
                              inputs["cache"])
    if n_micro is None:
        n_micro = default_microbatches(cfg, spec.global_batch)
    step = make_train_step(model, OptimizerConfig(), n_micro=n_micro)
    return op_stats.count(step, params, init_opt_state(params), inputs)


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def cell(arch: str, shape: str, chips: int = 8) -> Cell:
    """One cell at full size on meta tensors."""
    cfg, spec = get_config(arch), ALL_SHAPES[shape]
    reason = shape_applicable(cfg, spec)
    if reason:
        return Cell(arch, shape, None, reason=reason)
    params = build_model(cfg).param_struct()
    inputs = input_specs(cfg, spec)
    stats = step_stats(cfg, spec, params, inputs)
    terms = RooflineTerms(
        arch=arch, shape=shape, mesh=f"{chips}x{H100.name}", chips=chips,
        flops_global=stats.flops, bytes_global=stats.bytes_accessed,
        # the port's decode runs gemma2's windowed ring cache where the
        # cache outgrows the window (`cache_struct` picks it)
        bytes_analytic_global=analytic_memory_bytes(
            cfg, spec, n_micro=default_microbatches(cfg, spec.global_batch), windowed=True),
        collective_bytes_per_chip=0.0,
        model_flops=model_flops_for(cfg, spec),
    )
    return Cell(arch, shape, terms, (_bytes(params) + _bytes(inputs)) / chips)


def report_cells(archs: Sequence[str] = ASSIGNED, chips: int = 8) -> List[Cell]:
    return [cell(a, s, chips) for a in archs for s in ALL_SHAPES]


def _advice(t: RooflineTerms) -> str:
    if t.dominant == "compute":
        if t.useful_flops_frac < 0.5:
            return "compute-bound with low useful-flops fraction: cut remat/recompute or pad waste"
        return ("compute-bound near useful flops: raise tensor-core utilization (larger tiles, "
                "fused attention)")
    if t.dominant == "memory":
        return "HBM-bound: shrink bytes (fuse elementwise chains, narrower dtypes, windowed KV)"
    return ("collective-bound: reshard to cut all-gathers (2D weight sharding trades memory "
            "for comm)")


def markdown_table(cells: Sequence[Cell]) -> str:
    rows = [
        "| arch | shape | chips | compute_s | memory_s | mem_s(op-count ub) | collective_s | "
        "dominant | MODEL_FLOPS | useful/op-count | roofline_frac | HBM/chip | note |\n"
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|"
    ]
    for c in cells:
        if c.terms is None:
            rows.append(f"| {c.arch} | {c.shape} | — | — | — | — | skipped | — | — | — | — | — | "
                        f"{c.reason[:70]}… |")
            continue
        t = c.terms
        rows.append(
            f"| {c.arch} | {c.shape} | {t.chips} | {t.compute_s:.4g} | {t.memory_s:.4g} | "
            f"{t.memory_s_hlo:.4g} | {t.collective_s:.4g} | **{t.dominant}** | "
            f"{t.model_flops:.3g} | {t.useful_flops_frac:.2f} | {t.roofline_frac:.3f} | "
            f"{c.hbm_bytes_per_chip / 1e9:.1f} GB | {_advice(t)} |"
        )
    return "\n".join(rows)


def pick_hillclimb_cells(cells: Sequence[Cell]) -> Dict[str, Dict]:
    """The three hillclimb targets: worst roofline fraction, most
    collective-bound, most representative of the paper (decode step)."""
    counted = [c for c in cells if c.terms is not None]
    worst = min(counted, key=lambda c: c.terms.roofline_frac if c.terms.roofline_frac > 0
                else 1e9)
    coll = max(counted,
               key=lambda c: c.terms.collective_s / max(c.terms.step_time_bound_s, 1e-12))
    rep = max((c for c in counted if c.shape == "decode_32k"),
              key=lambda c: c.terms.model_flops)
    return {k: dict(cell=f"{c.arch}/{c.shape}", **c.terms.as_dict())
            for k, c in (("worst_roofline", worst), ("most_collective_bound", coll),
                         ("paper_representative", rep))}


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, default=8, help="H100s sharing each step (default 8)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    cells = report_cells(chips=args.chips)
    wall = time.perf_counter() - t0
    print(f"## Roofline ({args.chips} x {H100.name}, op counts on meta tensors)\n")
    print(markdown_table(cells))
    print("\n### Hillclimb targets\n")
    for k, v in pick_hillclimb_cells(cells).items():
        print(f"- **{k}**: {v['cell']} — dominant={v['dominant']}, "
              f"roofline_frac={v['roofline_frac']:.3f}")
    n = sum(c.terms is not None for c in cells)
    print(f"\n{n} cells counted, {len(cells) - n} skipped, in {wall:.1f} s")


if __name__ == "__main__":
    main()
