"""Elastic re-mesh dry-run: the same code places and counts a step on a
degraded device count (node failures at scale), with no code change (port
of ``repro.launch.elastic``).

Simulates losing 'data' rows of the single-pod mesh (16x16 -> 15x16 is not
expressible for every dim, so production policy shrinks to the largest
divisible rectangle: 8x16) and re-places the serve step with the same
sharding rules: the divisibility fallback re-resolves every dim. Each mesh
is built inside the fake process group of `launch.dryrun` (512 ranks,
meta tensors), and its step counted as a dry-run cell is: the count stands
where the reference's compile does.

    PYTHONPATH=src python -m repro_torch.launch.elastic --arch llama3-8b
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.dist.fault import FleetState, plan_recovery
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import init_fake_world, make_mesh


def check(arch: str, shape: str, mesh_shape, axes) -> dict:
    """Place and count ``shape``'s step of ``arch`` on a mesh of
    ``mesh_shape``: the serve plan for a decode shape, the train plan else."""
    init_fake_world(dryrun.WORLD)
    mesh = make_mesh(tuple(mesh_shape), tuple(axes), device="meta")
    t0 = time.time()
    res = dryrun.count_cell(arch, shape, mesh, "serve" if "decode" in shape else "train")
    return dict(
        mesh=str(tuple(mesh_shape)),
        chips=mesh.size(),
        count_s=round(time.time() - t0, 2),
        argument_gb=round(res["memory"]["argument_bytes"] / 1e9, 3),
        collective_bytes_per_chip=res["collectives"]["total"],
        collective_count=res["collectives"]["count"],
        fallbacks=res["sharding_fallbacks"],
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument(
        "--plan-fleet",
        default=None,
        help="comma-separated healthy chips per pod (e.g. '256,200'): print "
        "the dist.fault recovery narrative, then re-place onto the planned "
        "per-pod data x model rectangle",
    )
    args = ap.parse_args()
    init_fake_world(dryrun.WORLD)  # the one process group of this process

    if args.plan_fleet:
        fleet = FleetState(pods=tuple(int(x) for x in args.plan_fleet.split(",")))
        rec = plan_recovery(fleet)
        for line in rec.describe():
            print(line)
        shape = rec.mesh.shape[-2:]  # per-pod data x model rectangle
        res = check(args.arch, args.shape, shape, ("data", "model"))
        print("planned", json.dumps(res))
        print("elastic re-mesh from fault plan: OK")
        return

    results = {}
    for name, mesh_shape in [
        ("healthy_256", (16, 16)),
        ("degraded_128", (8, 16)),  # lost half the data rows
        ("degraded_64", (4, 16)),
    ]:
        results[name] = check(args.arch, args.shape, mesh_shape, ("data", "model"))
        print(name, json.dumps(results[name]))
    print("elastic re-mesh: OK — same code, three device counts")


if __name__ == "__main__":
    main()
