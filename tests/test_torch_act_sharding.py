"""The port's activation-sharding context (port of ``tests/test_act_sharding
.py``): an exact no-op outside a mesh context, the prior state restored on
exit and on an exception, applied under a context without changing values,
and an indivisible batch left as it is.

The checks run on a gloo mesh of 2 CPU processes (`make_host_mesh`: data 2,
model 1), spawned once by a module-scoped fixture with a timeout of its own;
rank 0 prints one JSON line, and the tests assert on it.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
SPAWN_TIMEOUT = 120


def _worker(rank: int, port: int) -> None:
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=WORLD)
    try:
        out = _rank_checks()
        if rank == 0:
            print(json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


def _rank_checks() -> dict:
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.dist.act_sharding import (
        active_context,
        constrain_batch,
        use_activation_sharding,
    )
    from repro_torch.dist.sharding import ShardingPlan
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh()
    out = {}

    def rep(x):
        return distribute_tensor(x, mesh, [Replicate(), Replicate()], src_data_rank=None)

    plain = [torch.arange(12, dtype=torch.bfloat16).reshape(4, 3),
             torch.ones((2, 3, 5)), torch.zeros((1,), dtype=torch.int32)]
    xs = plain + [rep(t) for t in plain]
    out["identity_outside"] = all(constrain_batch(x) is x for x in xs)

    seen = [active_context() is None]
    with use_activation_sharding(mesh, ("data",)):
        seen.append(active_context() == (mesh, ("data",)))
        with use_activation_sharding(mesh, ("data", "model")):
            seen.append(active_context() == (mesh, ("data", "model")))
        seen.append(active_context() == (mesh, ("data",)))
    seen.append(active_context() is None)
    out["restored_on_exit"] = seen

    try:
        with use_activation_sharding(mesh, ("data",)):
            raise ValueError("boom")
    except ValueError:
        pass
    x = rep(torch.ones((4, 2)))
    out["restored_on_exception"] = [active_context() is None, constrain_batch(x) is x]

    plan = ShardingPlan(mesh)
    x = rep(torch.arange(8, dtype=torch.float32).reshape(4, 2))
    p = torch.ones((4, 2))
    with use_activation_sharding(mesh, plan.batch_axes):
        y = constrain_batch(x)
        out["plain_under_context"] = constrain_batch(p) is p
    out["applied"] = dict(
        placements=[repr(q) for q in y.placements],
        want=[repr(Shard(0)), repr(Replicate())],
        values=torch.equal(y.full_tensor(), x.full_tensor()),
        dtype=y.dtype == x.dtype,
        local_rows=y.to_local().shape[0],
    )

    n = mesh.shape[0]
    x = rep(torch.ones((n + 1, 2)))
    with use_activation_sharding(mesh, ("data",)):
        out["indivisible_identity"] = constrain_batch(x) is x
    out["data_size"] = n
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def got():
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, __file__, "--worker", str(r), str(port)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a rank ran past {SPAWN_TIMEOUT} s")
    for r, (p, (_, err)) in enumerate(zip(procs, outs, strict=True)):
        assert p.returncode == 0, f"rank {r} failed:\n{err[-4000:]}"
    return json.loads(outs[0][0].strip().splitlines()[-1])


def test_constrain_batch_is_identity_outside_context(got):
    assert got["identity_outside"] is True


def test_context_restores_prior_state_on_exit(got):
    assert got["restored_on_exit"] == [True] * 5


def test_context_restores_state_on_exception(got):
    assert got["restored_on_exception"] == [True, True]


def test_constrain_applies_under_context_and_preserves_values(got):
    a = got["applied"]
    assert a["placements"] == a["want"]
    assert a["values"] and a["dtype"]
    assert a["local_rows"] * got["data_size"] == 4
    assert got["plain_under_context"] is True


def test_indivisible_batch_falls_back_to_identity(got):
    assert got["data_size"] == WORLD
    assert got["indivisible_identity"] is True


if __name__ == "__main__":
    if "--worker" in sys.argv:
        i = sys.argv.index("--worker")
        _worker(int(sys.argv[i + 1]), int(sys.argv[i + 2]))
