"""The port's sharding plan against the JAX package's, on the CPU with no
process group: the reference's ``ShardingPlan`` runs on a
``jax.sharding.AbstractMesh`` and the port's on the same ``(shape, names)``.

- Every ``ASSIGNED`` architecture and its ``-smoke`` variant, in the modes
  train, serve, dp and zero, on the meshes (16, 16), (2, 16, 16), (8, 16),
  (4, 16), (2, 4) and (1, 1): the parameter specs equal ``param_pspecs``'
  leaf for leaf, and ``fallbacks`` equal the reference's in order, letter
  for letter.
- The decode cache's specs (every family) and the input specs of every
  ``ALL_SHAPES`` entry equal the reference's.
- ``placements`` round-trips through ``spec_of``; one rank's shard bytes
  equal the sum over leaves of JAX's ``NamedSharding(mesh, spec).
  shard_shape``.
- ``serving.kvcache.cache_batch_dim`` equals the reference's.

The structures are built once per architecture (meta tensors in the port,
``ShapeDtypeStruct``s in JAX), so the file runs in seconds.
"""
import functools
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import ALL_SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import input_specs as jax_input_specs  # noqa: E402
from repro.dist import sharding as jax_sharding  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models.model import cache_struct as jax_cache_struct  # noqa: E402
from repro.serving import kvcache as jax_kvcache  # noqa: E402
from repro_torch.configs import ALL_SHAPES, ASSIGNED, get_config, input_specs  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.model import cache_struct  # noqa: E402
from repro_torch.serving import kvcache  # noqa: E402

ARCHS = [a for arch in ASSIGNED for a in (arch, arch + "-smoke")]
MODES = ("train", "serve", "dp", "zero")
MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "8x16": ((8, 16), ("data", "model")),
    "4x16": ((4, 16), ("data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "1x1": ((1, 1), ("data", "model")),
}
DECODE_BATCH, DECODE_LEN = 128, 64  # the cache rules read the batch and heads dims


@functools.lru_cache(maxsize=None)
def _structs(arch):
    """(JAX param struct, port param struct) of ``arch``."""
    return (jax_build_model(jax_get_config(arch)).param_struct(),
            build_model(get_config(arch)).param_struct())


@functools.lru_cache(maxsize=None)
def _abstract(mesh_id):
    shape, names = MESHES[mesh_id]
    return AbstractMesh(shape, names)


def _jax_flat(tree):
    """{dotted path: leaf} of a JAX tree (PartitionSpecs as leaves)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))
    return {".".join(jax_sharding._path_parts(p)): leaf for p, leaf in flat}


def _port_flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_port_flat(tree[k], f"{prefix}.{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _same_specs(jax_specs, port_specs):
    j, p = _jax_flat(jax_specs), _port_flat(port_specs)
    assert sorted(j) == sorted(p)
    for path in j:
        assert isinstance(p[path], sharding.PartitionSpec), path
        assert tuple(p[path]) == tuple(j[path]), (path, p[path], j[path])


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_fallbacks_equal_the_reference(arch, mode, mesh_id):
    jstruct, pstruct = _structs(arch)
    jplan = jax_sharding.ShardingPlan(_abstract(mesh_id), mode=mode)
    pplan = sharding.ShardingPlan(MESHES[mesh_id], mode=mode)
    jspecs = jax_sharding.param_pspecs(jax_get_config(arch), jstruct, jplan)
    pspecs = sharding.param_pspecs(get_config(arch), pstruct, pplan)
    _same_specs(jspecs, pspecs)
    assert pplan.fallbacks == jplan.fallbacks
    assert pplan.batch_axes == jplan.batch_axes


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_input_specs_equal_the_reference(arch, mesh_id):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jplan = jax_sharding.ShardingPlan(_abstract(mesh_id), mode="serve")
    pplan = sharding.ShardingPlan(MESHES[mesh_id], mode="serve")
    _same_specs(
        jax_sharding.cache_pspecs(jcfg, jax_cache_struct(jcfg, DECODE_BATCH, DECODE_LEN), jplan),
        sharding.cache_pspecs(cfg, cache_struct(cfg, DECODE_BATCH, DECODE_LEN), pplan))
    for name in ALL_SHAPES:
        _same_specs(jax_sharding.input_pspecs(jcfg, jax_input_specs(jcfg, JAX_SHAPES[name]), jplan),
                    sharding.input_pspecs(cfg, input_specs(cfg, ALL_SHAPES[name]), pplan))
    assert pplan.fallbacks == jplan.fallbacks


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_placements_round_trip_and_shard_bytes_equal_jax(arch, mesh_id):
    from torch.distributed.tensor import Replicate, Shard

    jstruct, pstruct = _structs(arch)
    mesh = MESHES[mesh_id]
    for mode in ("train", "zero"):
        jspecs = jax_sharding.param_pspecs(jax_get_config(arch), jstruct,
                                           jax_sharding.ShardingPlan(_abstract(mesh_id), mode))
        pspecs = sharding.param_pspecs(get_config(arch), pstruct,
                                       sharding.ShardingPlan(mesh, mode))
        for spec in sharding.tree_specs(pspecs):
            pl = sharding.placements(spec, mesh)
            assert len(pl) == len(mesh[0])
            assert all(isinstance(p, (Shard, Replicate)) for p in pl)
            trimmed = list(spec)
            while trimmed and trimmed[-1] is None:
                trimmed.pop()
            assert tuple(sharding.spec_of(pl, mesh)) == tuple(trimmed)
        jflat, pflat = _jax_flat(jstruct), _port_flat(pstruct)
        jspec_flat = _jax_flat(jspecs)
        want = sum(math.prod(NamedSharding(_abstract(mesh_id), jspec_flat[k]).shard_shape(
            jflat[k].shape)) * jflat[k].dtype.itemsize for k in jflat)
        assert sharding.shard_bytes(pstruct, pspecs, mesh) == want


def test_joint_candidates_are_the_batch_axes_in_mesh_order():
    """A dim sharded on (pod, data) is Shard(dim) on both mesh dims; a joint
    entry out of mesh order is refused."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = MESHES["2x16x16"]
    plan = sharding.ShardingPlan(mesh)
    assert plan.batch_axes == ("pod", "data")
    spec = sharding.PartitionSpec(plan.batch_axes, None, "model")
    assert sharding.placements(spec, mesh) == (Shard(0), Shard(0), Shard(2))
    assert sharding.placements(sharding.PartitionSpec(("data",), None), MESHES["16x16"]) == (
        Shard(0), Replicate())
    with pytest.raises(ValueError, match="mesh order"):
        sharding.placements(sharding.PartitionSpec(("data", "pod")), mesh)
    assert sharding.shard_shape((64, 3, 32), spec, mesh) == (2, 3, 2)


def test_a_bare_mesh_a_jax_like_mesh_and_a_device_mesh_name_the_same_axes():
    assert sharding.mesh_axes(((2, 4), ("data", "model"))) == {"data": 2, "model": 4}
    assert sharding.mesh_axes(_abstract("2x16x16")) == {"pod": 2, "data": 16, "model": 16}
    with pytest.raises(ValueError):
        sharding.mesh_axes(((2, 4), ("data",)))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_batch_dim_equals_the_reference(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    names = set(cache_struct(cfg, 2, 16)) | {"k", "v", "conv", "state", "self_k", "cross_v"}
    for name in sorted(names):
        assert kvcache.cache_batch_dim(cfg, name) == jax_kvcache.cache_batch_dim(jcfg, name)
