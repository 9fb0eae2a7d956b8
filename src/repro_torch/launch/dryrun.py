"""Multi-pod dry-run: place and count every (arch x shape x mesh) cell (port of
``repro.launch.dryrun``).

Per cell the dry-run:
  1. builds the model and the step function (the training step, `Model.
     prefill` or `Model.decode`),
  2. places the parameters, optimizer state, cache and inputs on the
     production mesh by the sharding plan, as meta DTensors,
  3. runs the step once under `roofline.op_stats` inside the activation
     sharding context,
  4. records the per-rank argument bytes, the global FLOPs and bytes, the
     collectives by kind and mesh dim, the sharding fallbacks and timings
     to ``artifacts/dryrun_torch/<cell>.json``.

The reference lowers and compiles each cell on 512 placeholder XLA host
devices; the port has no compiler, so it runs the step on ``meta`` tensors
(nothing is allocated) under PyTorch's fake process group of 512 ranks
(`launch.mesh.init_fake_world`; this process is rank 0, collectives are
accepted and move nothing, meshes are built with device type "cpu").

The counts follow fixed rules (the reference keeps its own):
- FLOPs and bytes are global (`RooflineTerms.flops_global`, ``bytes_global``):
  a dispatch mode sees a DTensor op at its global shapes, and a
  hand-written kernel's ``work()`` is added once per call at its global
  shapes, not once per rank inside ``local_map``. A dim that falls back to
  replication is computed on every rank but counted once.
- Collective bytes are per rank, on the wire by the reference's ring model
  (`op_stats.wire_bytes`), by kind and by mesh dim, with their count: every
  collective the step issues, DTensor's own redistributions included. On a
  host mesh (device type "cpu") DTensor replaces an all-to-all by an
  all-gather and a chunk, as it does for gloo, so that reshard counts as an
  all-gather.
- ``argument_bytes`` is one rank's bytes of the parameters, optimizer state,
  cache and inputs as placed (the counterpart of XLA's
  ``memory_analysis().argument_size_in_bytes``). XLA's ``temp_bytes`` (the
  compiled program's scratch) has no counterpart without a compiler and is
  written ``null``.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--skip-existing]
  python -m repro_torch.launch.dryrun --calibrate
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.configs import ALL_SHAPES, ASSIGNED, get_config, input_specs, shape_applicable
from repro_torch.dist.act_sharding import use_activation_sharding
from repro_torch.dist.sharding import (
    ShardingPlan,
    cache_pspecs,
    distribute,
    input_pspecs,
    named,
    param_pspecs,
)
from repro_torch.launch.mesh import init_fake_world, make_production_mesh
from repro_torch.models import build_model
from repro_torch.roofline import op_stats
from repro_torch.roofline.analysis import RooflineTerms, analytic_memory_bytes, model_flops_for
from repro_torch.training.optimizer import OptimizerConfig, init_opt_state, tree_leaves
from repro_torch.training.train_step import make_train_step

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts", "dryrun_torch")
WORLD = 512  # ranks of the fake group: the multi-pod mesh, and every smaller one inside it

DEFAULT_MICRO = 8  # train_4k: 256-batch -> 8 microbatches of 32


def local_bytes(tree) -> int:
    """One rank's bytes of a tree of (D)Tensors as placed."""
    total = 0
    for t in tree_leaves(tree):
        local = t.to_local() if hasattr(t, "to_local") else t
        total += local.numel() * local.element_size()
    return total


def build_cell(arch: str, shape_name: str, mesh, sharding_mode: str = "train",
               n_micro: Optional[int] = None):
    """Returns (fn, args, meta): ``fn(*args)`` is the cell's step on meta
    DTensors placed on ``mesh``; ``meta`` holds the plan, the per-rank
    argument bytes by part, and ``n_micro`` for a training cell."""
    cfg = get_config(arch).replace(attn_impl="pallas")  # the kernels' wrappers, as on the card
    spec = ALL_SHAPES[shape_name]
    model = build_model(cfg)
    plan = ShardingPlan(mesh, mode=sharding_mode)
    specs = input_specs(cfg, spec)

    params_struct = model.param_struct()
    p_pspec = param_pspecs(cfg, params_struct, plan)
    params = distribute(params_struct, p_pspec, mesh)
    parts = dict(params=local_bytes(params))

    if spec.kind == "train":
        opt = init_opt_state(params)
        batch_pspec = input_pspecs(cfg, specs, plan)
        batch = distribute(specs, batch_pspec, mesh)
        if n_micro is None:
            n_micro = DEFAULT_MICRO if spec.global_batch % DEFAULT_MICRO == 0 else 1
        # each microbatch keeps the batch's spec, as the reference's scan body
        step = make_train_step(model, OptimizerConfig(), n_micro=n_micro,
                               grad_shardings=named(mesh, p_pspec),
                               micro_shardings=named(mesh, batch_pspec))
        parts.update(opt_state=local_bytes(opt.m) + local_bytes(opt.v)
                     + opt.step.numel() * opt.step.element_size(),
                     inputs=local_bytes(batch))
        return step, (params, opt, batch), dict(plan=plan, parts=parts, n_micro=n_micro, cfg=cfg)

    if spec.kind == "prefill":
        batch = distribute(specs, input_pspecs(cfg, specs, plan), mesh)
        parts.update(inputs=local_bytes(batch))
        return model.prefill, (params, batch), dict(plan=plan, parts=parts, cfg=cfg)

    # decode / serve step
    c_pspec = cache_pspecs(cfg, specs["cache"], plan)
    tok_pspec = input_pspecs(cfg, dict(t=specs["tokens"]), plan)["t"]
    pos_pspec = input_pspecs(cfg, dict(t=specs["positions"]), plan)["t"]
    cache = distribute(specs["cache"], c_pspec, mesh)
    tokens = distribute(specs["tokens"], tok_pspec, mesh)
    positions = distribute(specs["positions"], pos_pspec, mesh)
    parts.update(cache=local_bytes(cache), inputs=local_bytes(tokens) + local_bytes(positions))
    return model.decode, (params, tokens, positions, cache), dict(plan=plan, parts=parts, cfg=cfg)


def collectives_of(stats: op_stats.OpStats, mesh) -> Dict:
    """The reference's ``collectives`` record ({kind: bytes, "total",
    "count"}) plus the count and bytes by mesh dim and kind."""
    out: Dict = {}
    for (kind, _, _), (_, _, wire) in stats.collectives.items():
        out[kind] = out.get(kind, 0.0) + wire
    out["total"] = stats.collective_bytes
    out["count"] = stats.collective_count
    out["by_mesh_dim"] = {dim: {k: dict(count=int(c), bytes=b) for k, (c, b) in kinds.items()}
                          for dim, kinds in op_stats.by_mesh_dim(stats, mesh).items()}
    return out


def count_cell(arch: str, shape_name: str, mesh, sharding_mode: str = "train",
               n_micro: Optional[int] = None) -> Dict:
    """Build and count one cell on ``mesh`` (the fake group started):
    everything `run_cell` records but the status."""
    spec = ALL_SHAPES[shape_name]
    t0 = time.time()
    fn, args, meta = build_cell(arch, shape_name, mesh, sharding_mode, n_micro)
    t_build = time.time() - t0
    t0 = time.time()
    with use_activation_sharding(mesh, meta["plan"].batch_axes):
        stats = op_stats.count(fn, *args)
    t_count = time.time() - t0
    cfg, chips = meta["cfg"], mesh.size()
    colls = collectives_of(stats, mesh)
    terms = RooflineTerms(
        arch=arch, shape=shape_name, mesh="x".join(map(str, mesh.shape)), chips=chips,
        flops_global=stats.flops, bytes_global=stats.bytes_accessed,
        collective_bytes_per_chip=stats.collective_bytes,
        model_flops=model_flops_for(cfg, spec),
        bytes_analytic_global=analytic_memory_bytes(
            cfg, spec, n_micro=meta.get("n_micro") or DEFAULT_MICRO, windowed=True),
    )
    return dict(
        chips=chips,
        build_s=round(t_build, 2),
        count_s=round(t_count, 2),
        flops=float(stats.flops),
        bytes_accessed=float(stats.bytes_accessed),
        kernels={k: dict(calls=int(v[0]), flops=v[1], bytes=v[2])
                 for k, v in stats.kernels.items()},
        memory=dict(argument_bytes=int(sum(meta["parts"].values())),
                    **{f"{k}_bytes": int(v) for k, v in meta["parts"].items()},
                    temp_bytes=None),
        collectives=colls,
        model_flops=model_flops_for(cfg, spec),
        params=cfg.count_params(),
        active_params=cfg.count_active_params(),
        sharding_fallbacks=list(meta["plan"].fallbacks),
        n_micro=meta.get("n_micro"),
        roofline=dict(terms.as_dict(), step_time_bound_s=terms.step_time_bound_s),
    )


def run_cell(
    arch: str, shape_name: str, mesh_kind: str, skip_existing: bool = False,
    sharding_mode: str = "train", tag: str = "", n_micro: Optional[int] = None,
) -> Dict:
    os.makedirs(ARTIFACTS, exist_ok=True)
    cell = f"{arch}__{shape_name}__{mesh_kind}" + (f"__{tag}" if tag else "")
    path = os.path.join(ARTIFACTS, cell + ".json")
    if skip_existing and os.path.exists(path):
        with open(path) as f:
            return json.load(f)

    cfg = get_config(arch)
    spec = ALL_SHAPES[shape_name]
    out: Dict = dict(arch=arch, shape=shape_name, mesh=mesh_kind, sharding_mode=sharding_mode,
                     tag=tag)

    reason = shape_applicable(cfg, spec)
    if reason is not None:
        out.update(status="skipped", reason=reason)
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        return out

    t0 = time.time()
    try:
        init_fake_world(WORLD)
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device="meta")
        out.update(status="ok", **count_cell(arch, shape_name, mesh, sharding_mode, n_micro))
    except Exception as e:  # a failure here is a bug in the system: record it
        out.update(status="error", error=f"{type(e).__name__}: {e}",
                   tb=traceback.format_exc()[-4000:])
    out["wall_s"] = round(time.time() - t0, 2)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return out


def calibrate() -> Dict:
    """The count's semantics: a 4096^3 bf16 matmul sharded (data, None) x
    (None, model) on the 16x16 mesh must count 2 * 4096^3 FLOPs (global)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    init_fake_world(WORLD)
    mesh = make_production_mesh(multi_pod=False, device="meta")
    n = 4096
    a = distribute_tensor(torch.empty((n, n), dtype=torch.bfloat16, device="meta"), mesh,
                          [Shard(0), Replicate()], src_data_rank=None)
    b = distribute_tensor(torch.empty((n, n), dtype=torch.bfloat16, device="meta"), mesh,
                          [Replicate(), Shard(1)], src_data_rank=None)
    stats = op_stats.count(lambda x, y: x @ y, a, b)
    true_global = 2.0 * n * n * n
    ratio = stats.flops / true_global
    sem = "global" if ratio > 0.5 else "per_partition"
    result = dict(reported=stats.flops, true_global=true_global, ratio=ratio, semantics=sem,
                  chips=mesh.size(), collective_bytes=stats.collective_bytes)
    os.makedirs(ARTIFACTS, exist_ok=True)
    with open(os.path.join(ARTIFACTS, "_calibration.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def summary(res: Dict) -> str:
    """One line of a cell's record (the count's numbers, not a device's)."""
    status = res.get("status")
    if status == "ok":
        coll = res["collectives"]
        kinds = " ".join(f"{k}={v:.4g}B" for k, v in coll.items()
                         if k not in ("total", "count", "by_mesh_dim"))
        r = res["roofline"]
        return (f"arg/rank={res['memory']['argument_bytes'] / 1e9:.3f}GB "
                f"flops={res['flops']:.4g} coll/chip={coll['total']:.4g}B ({kinds or 'none'}) "
                f"n_coll={coll['count']} fallbacks={len(res['sharding_fallbacks'])} "
                f"dominant={r['dominant']} bound={r['step_time_bound_s']:.4g}s")
    if status == "error":
        return res["error"][:160]
    return "skipped"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--calibrate", action="store_true")
    ap.add_argument("--sharding-mode", default="train", choices=["train", "serve", "dp", "zero"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--n-micro", type=int, default=None)
    args = ap.parse_args()
    init_fake_world(WORLD)  # the one process group of this process

    if args.calibrate:
        print(json.dumps(calibrate(), indent=1))
        return

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = ASSIGNED if args.all or args.arch is None else [args.arch]
    shapes = list(ALL_SHAPES) if args.all or args.shape is None else [args.shape]

    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                t0 = time.time()
                res = run_cell(arch, shape, mk, skip_existing=args.skip_existing,
                               sharding_mode=args.sharding_mode, tag=args.tag,
                               n_micro=args.n_micro)
                print(f"[{time.time() - t0:7.1f}s] {arch:26s} {shape:12s} {mk:6s} "
                      f"{res.get('status')} {summary(res)}", flush=True)


if __name__ == "__main__":
    main()
