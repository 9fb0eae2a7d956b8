"""The port's dry-run and elastic re-mesh (``launch/dryrun.py``,
``launch/elastic.py``) on meta tensors under PyTorch's fake process group.

The fake group is one per process, so every case runs in a subprocess
(artifacts go to a temporary directory):

- ``run_cell`` of llama3-8b-smoke at ``decode_32k`` and ``train_4k`` on the
  single-pod mesh ends ``ok``; its per-rank argument bytes equal the sum
  over the reference's specs (``repro.dist.sharding`` on an
  ``AbstractMesh``) of JAX's ``NamedSharding.shard_shape`` bytes; the train
  cell counts collective bytes above 0, and its kernels once per call at
  global shapes;
- ``--calibrate`` reports global semantics (2 * 4096^3 FLOPs);
- one all-gather and one reduce-scatter made by hand on the fake mesh count
  exactly ``wire_bytes``, which equals the reference's ``_wire_bytes`` for
  every kind and group size from 1 to 16;
- elastic ``check`` runs on the 16x16, 8x16 and 4x16 meshes, and
  ``--plan-fleet 256,200`` prints the recovery narrative.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

import jax  # noqa: E402
from repro.configs import ALL_SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import input_specs as jax_input_specs  # noqa: E402
from repro.dist import sharding as jax_sharding  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.roofline.analysis import _wire_bytes  # noqa: E402
from repro_torch.roofline.op_stats import wire_bytes  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")


def _python(code: str, *args: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, *(["-c", code] if code else []), *args], env=env,
                          cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


_CELL = """
import json, sys
from repro_torch.launch import dryrun
dryrun.ARTIFACTS = sys.argv[1]
print(json.dumps(dryrun.run_cell("llama3-8b-smoke", sys.argv[2], "single")))
"""


def _jax_argument_bytes(arch: str, shape: str) -> int:
    """Per-rank bytes of the cell's arguments under the reference's specs on
    the 16x16 mesh (train mode, as ``run_cell``'s default)."""
    cfg = jax_get_config(arch)
    mesh = AbstractMesh((16, 16), ("data", "model"))
    plan = jax_sharding.ShardingPlan(mesh, mode="train")
    spec = JAX_SHAPES[shape]
    params = jax_build_model(cfg).param_struct()
    pspecs = jax_sharding.param_pspecs(cfg, params, plan)
    inputs = jax_input_specs(cfg, spec)

    def total(tree, specs, itemsize=None):
        leaves = jax.tree_util.tree_leaves(tree)
        ss = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, JP))
        return sum(math.prod(NamedSharding(mesh, s).shard_shape(t.shape))
                   * (itemsize or t.dtype.itemsize) for t, s in zip(leaves, ss, strict=True))

    n = total(params, pspecs)
    if spec.kind == "train":
        n += 2 * total(params, pspecs, itemsize=4) + 4  # f32 m and v, the int32 step
    return n + total(inputs, jax_sharding.input_pspecs(cfg, inputs, plan))


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
def test_run_cell_is_ok_with_the_reference_s_argument_bytes(shape, tmp_path):
    res = json.loads(_python(_CELL, str(tmp_path), shape).strip().splitlines()[-1])
    assert res["status"] == "ok", res.get("error")
    assert res["chips"] == 256
    assert (tmp_path / f"llama3-8b-smoke__{shape}__single.json").exists()
    assert res["memory"]["argument_bytes"] == _jax_argument_bytes("llama3-8b-smoke", shape)
    assert res["memory"]["temp_bytes"] is None
    assert res["flops"] > 0 and res["bytes_accessed"] > 0
    coll = res["collectives"]
    assert coll["total"] == sum(v for k, v in coll.items()
                                if k not in ("total", "count", "by_mesh_dim"))
    assert res["roofline"]["collective_bytes_per_chip"] == coll["total"]
    if shape == "train_4k":
        assert coll["total"] > 0 and coll["count"] > 0
        assert set(coll["by_mesh_dim"]) <= {"data", "model"}
        # 8 microbatches x 2 layers, remat runs each forward twice
        assert res["kernels"]["prefill_attention"]["calls"] == 32
        assert res["kernels"]["prefill_attention_bwd"]["calls"] == 16
    else:
        assert res["kernels"]["decode_attention"]["calls"] == 2
    assert res["sharding_fallbacks"] == (
        [] if shape == "train_4k" else
        ["k.heads: dim 2 not divisible by model=16 -> replicated",
         "v.heads: dim 2 not divisible by model=16 -> replicated"])


def test_calibrate_reports_global_semantics(tmp_path):
    code = ("import sys; from repro_torch.launch import dryrun; dryrun.ARTIFACTS = sys.argv[1]; "
            "sys.argv = ['dryrun', '--calibrate']; dryrun.main()")
    res = json.loads(_python(code, str(tmp_path)))
    assert res["semantics"] == "global"
    assert res["reported"] == res["true_global"] == 2.0 * 4096 ** 3
    assert res["chips"] == 256


_COLLECTIVES = """
import json, torch
from torch.distributed.tensor import Partial, Replicate, Shard, DTensor
from repro_torch.launch.mesh import init_fake_world, make_mesh
from repro_torch.roofline import op_stats
init_fake_world(256)
mesh = make_mesh((16, 16), ("data", "model"), device="meta")
x = DTensor.from_local(torch.empty((64, 32), device="meta"), mesh, [Replicate(), Shard(0)])
y = DTensor.from_local(torch.empty((1024, 32), device="meta"), mesh, [Replicate(), Partial()])
with op_stats.counting() as st:
    x.redistribute(mesh, [Replicate(), Replicate()])
    y.redistribute(mesh, [Replicate(), Shard(0)])
print(json.dumps(dict(
    colls=[[k[0], k[2], v] for k, v in st.collectives.items()],
    dims=op_stats.by_mesh_dim(st, mesh), total=st.collective_bytes,
    flops=st.flops)))
"""


def test_hand_made_collectives_count_the_ring_model():
    res = json.loads(_python(_COLLECTIVES).strip().splitlines()[-1])
    got = {kind: (g, calls, rb, wire) for kind, g, (calls, rb, wire) in res["colls"]}
    assert set(got) == {"all-gather", "reduce-scatter"}
    # all-gather: the gathered (16*64, 32) f32 tensor is the result
    gathered = 16 * 64 * 32 * 4
    assert got["all-gather"] == (16, 1, gathered, wire_bytes("all-gather", gathered, 16))
    # reduce-scatter: the (64, 32) piece is the result
    assert got["reduce-scatter"] == (16, 1, 64 * 32 * 4,
                                     wire_bytes("reduce-scatter", 64 * 32 * 4, 16))
    assert res["total"] == 15 * 64 * 32 * 4 * 2
    assert set(res["dims"]) == {"model"} and res["flops"] == 0


def test_wire_bytes_is_the_reference_s():
    for kind in KINDS:
        for g in range(1, 17):
            for nbytes in (0, 1, 4096, 3 * 10 ** 9):
                assert wire_bytes(kind, nbytes, g) == _wire_bytes(kind, nbytes, g)


def test_elastic_check_on_three_meshes():
    out = _python("", "-m", "repro_torch.launch.elastic", "--arch", "llama3-8b-smoke")
    rows = {ln.split(" ", 1)[0]: json.loads(ln.split(" ", 1)[1]) for ln in out.splitlines()
            if ln.startswith(("healthy", "degraded"))}
    assert [r["chips"] for r in rows.values()] == [256, 128, 64]
    assert [r["mesh"] for r in rows.values()] == ["(16, 16)", "(8, 16)", "(4, 16)"]
    assert all(r["argument_gb"] > 0 for r in rows.values())
    assert "elastic re-mesh: OK" in out


def test_plan_fleet_prints_the_recovery_narrative():
    out = _python("", "-m", "repro_torch.launch.elastic", "--arch", "llama3-8b-smoke",
                  "--plan-fleet", "256,200")
    assert "1. drain" in out and "2. checkpoint" in out and "reset_for_restart" in out
    planned = json.loads(next(ln for ln in out.splitlines() if ln.startswith("planned "))[8:])
    assert planned["mesh"] == "(12, 16)" and planned["chips"] == 192
    assert "elastic re-mesh from fault plan: OK" in out
