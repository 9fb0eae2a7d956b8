"""Sharding rules: mesh-axis assignment with divisibility fallback (port of
``repro.dist.sharding``), and their placement on a torch ``DeviceMesh``.

The rules are the reference's, resolved by *dimension size*: every
parameter / cache / input leaf asks the ``ShardingPlan`` which mesh axes may
shard each of its dims, and ``pick()`` only grants an axis whose size
divides the dim. Anything indivisible falls back to replication and is
recorded in ``plan.fallbacks``, with the reference's labels letter for
letter (the dry-run writes that list into its artifacts).

A spec is a `PartitionSpec`: a tuple with one entry per tensor dim, each
``None`` (replicated), a mesh axis name, or a tuple of names sharding that
dim jointly, as JAX's ``PartitionSpec`` (a one-name tuple is that name).
`placements` turns it into DTensor placements, one per mesh dim: a mesh dim
whose name appears in entry *i* is ``Shard(i)``, every other one
``Replicate()``. The reference's joint candidates are always the plan's
``batch_axes``, in mesh order, so a dim sharded on ``("pod", "data")`` is
``Shard(0)`` on both mesh dims, split pod-major as JAX splits it.

A mesh is a torch ``DeviceMesh`` with dim names, an object with JAX's
``.shape`` mapping and ``.axis_names``, or a bare ``(shape, names)`` pair, so
a plan needs no process group (`mesh_axes`).

Entry points (spec trees mirror the input trees, nested dicts):

  plan  = ShardingPlan(mesh, mode="train")
  specs = param_pspecs(cfg, model.param_struct(), plan)
  specs = cache_pspecs(cfg, cache_struct, plan)
  specs = input_pspecs(cfg, input_specs(cfg, shape), plan)
  tree  = distribute(params, specs, device_mesh)
"""
from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig

log = logging.getLogger(__name__)

# A candidate is one mesh axis name, or a tuple of names sharded jointly.
Candidate = Union[str, Tuple[str, ...]]

_MODEL_AXIS = "model"


class PartitionSpec(tuple):
    """One entry per tensor dim: None, an axis name or a tuple of names (a
    one-name tuple is stored as the name, as JAX stores it)."""

    def __new__(cls, *entries):
        norm = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} in mesh order, of a ``DeviceMesh``, a JAX-like mesh
    (``.shape`` mapping, ``.axis_names``) or a ``(shape, names)`` pair."""
    if isinstance(mesh, tuple) and len(mesh) == 2:
        shape, names = mesh
    elif hasattr(mesh, "mesh_dim_names"):
        shape, names = tuple(mesh.shape), mesh.mesh_dim_names
    else:
        names = tuple(mesh.axis_names)
        shape = tuple(dict(mesh.shape)[a] for a in names)
    if names is None or len(names) != len(shape):
        raise ValueError(f"a mesh needs one name per dim, got shape {shape} names {names}")
    return dict(zip(names, (int(s) for s in shape), strict=True))


class ShardingPlan:
    """Per-(mesh, mode) axis assignment state.

    mode:
      train / serve  tensor-parallel params on the model axis (default)
      dp             pure data parallel: params fully replicated
      zero           tensor parallel + ZeRO-style sharding of one leftover
                     param dim across the batch axes
    """

    def __init__(self, mesh, mode: str = "train"):
        self.mesh = mesh
        self.mode = mode
        self.sizes: Dict[str, int] = mesh_axes(mesh)
        self.fallbacks: List[str] = []  # human/JSON-readable fallback records

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.sizes)

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """Mesh axes the batch dim spans (everything but the model axis)."""
        return tuple(a for a in self.sizes if a != _MODEL_AXIS)

    def _axes_of(self, cand: Candidate) -> Tuple[str, ...]:
        return (cand,) if isinstance(cand, str) else tuple(cand)

    def pick(
        self,
        dim_size: int,
        candidate_axes: Sequence[Candidate],
        used_axes: Set[str],
        label: str,
    ) -> Optional[Candidate]:
        """Assign the first candidate whose mesh axes all exist, are unused
        in this leaf, and whose combined size divides ``dim_size``. Returns
        the candidate (str or tuple) and marks its axes used; returns None
        (replicated) and records a fallback when no candidate fits."""
        tried = []
        for cand in candidate_axes:
            axes = self._axes_of(cand)
            if not axes:
                continue
            if any(a not in self.sizes for a in axes):
                continue
            if any(a in used_axes for a in axes):
                continue
            n = math.prod(self.sizes[a] for a in axes)
            if dim_size % n == 0:
                used_axes.update(axes)
                return cand
            tried.append(f"{cand}={n}")
        if tried:
            rec = (
                f"{label}: dim {dim_size} not divisible by "
                f"{', '.join(tried)} -> replicated"
            )
            self.fallbacks.append(rec)
            log.info("sharding fallback: %s", rec)
        return None


# ---------------------------------------------------------------------------
# tree walk: nested dicts in sorted key order (JAX's order, so fallbacks
# are recorded in the reference's order)
# ---------------------------------------------------------------------------

def _map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        out = {k: _map_with_path(fn, tree[k], (*path, str(k))) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    return fn(list(path), tree)


def tree_specs(tree) -> List:
    """The leaves of a spec tree (or any tree of dicts) in sorted key order."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in tree_specs(tree[k])]
    return [tree]


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

def _model_shardable_sizes(cfg: ModelConfig) -> Set[int]:
    """Dim sizes eligible for the tensor-parallel (model) axis: vocab, ffn,
    projected head dims, and the fused SSM channel dims."""
    hd = cfg.resolved_head_dim
    sizes = {
        cfg.vocab_size,
        cfg.d_ff,
        cfg.num_heads * hd,
        cfg.num_kv_heads * hd,
    }
    if cfg.ssm_state_dim:
        di = cfg.ssm_d_inner
        gn = cfg.ssm_ngroups * cfg.ssm_state_dim
        sizes |= {
            di,
            di + 2 * gn,  # conv channels
            2 * di + 2 * gn + cfg.ssm_num_heads,  # fused in_proj
            cfg.ssm_num_heads,
        }
    sizes.discard(0)
    return sizes


_STACKED_CONTAINERS = {"layers", "enc_layers", "dec_layers"}


def _n_stacked_dims(cfg: ModelConfig, parts: List[str]) -> int:
    """Leading scan-stacked dims (replicated): 1 for layer stacks, 2 for the
    hybrid family's (super_block, period) double stack."""
    if not parts or parts[0] not in _STACKED_CONTAINERS:
        return 0
    if cfg.family == "hybrid" and parts[0] == "layers":
        return 2
    return 1


def _param_spec(cfg: ModelConfig, plan: ShardingPlan, parts: List[str], shape) -> P:
    label = ".".join(parts) or "param"
    nd = len(shape)
    lead = min(_n_stacked_dims(cfg, parts), nd)
    entries: List[Optional[Candidate]] = [None] * nd
    used: Set[str] = set()
    model_sizes = _model_shardable_sizes(cfg)

    if plan.mode != "dp":
        # tensor parallel: shard the rightmost eligible dim on the model axis
        for i in range(nd - 1, lead - 1, -1):
            if shape[i] in model_sizes:
                entries[i] = plan.pick(
                    shape[i], [_MODEL_AXIS], used, f"{label}[{i}]"
                )
                if entries[i] is not None:
                    break

    if plan.mode == "zero" and plan.batch_axes:
        # ZeRO-style: spread one leftover dim across the batch axes
        for i in range(lead, nd):
            if entries[i] is None and shape[i] > 1:
                got = plan.pick(
                    shape[i], [plan.batch_axes], used, f"{label}[{i}].zero"
                )
                if got is not None:
                    entries[i] = got
                    break

    return P(*entries)


def param_pspecs(cfg: ModelConfig, param_struct, plan: ShardingPlan):
    """PartitionSpec tree matching ``param_struct``'s tree (tensors or
    anything with ``.shape``: meta tensors of `Model.param_struct`)."""
    return _map_with_path(lambda parts, leaf: _param_spec(cfg, plan, parts, leaf.shape),
                          param_struct)


# ---------------------------------------------------------------------------
# cache rules
# ---------------------------------------------------------------------------

# KV-style leaves: (...layer stack..., B, M, H, D)
_KV_KEYS = {"k", "v", "k_local", "v_local", "self_k", "self_v", "cross_k", "cross_v"}


def _cache_spec(plan: ShardingPlan, key: str, shape, label: str) -> P:
    nd = len(shape)
    entries: List[Optional[Candidate]] = [None] * nd
    used: Set[str] = set()
    batch = plan.batch_axes

    def assign(idx: int, cands: Sequence[Candidate], what: str) -> None:
        if 0 <= idx < nd and cands:
            entries[idx] = plan.pick(shape[idx], cands, used, f"{label}.{what}")

    if key in _KV_KEYS:
        assign(nd - 4, [batch], "batch")
        assign(nd - 2, [_MODEL_AXIS], "heads")
    elif key == "conv":  # (..., B, W-1, C)
        assign(nd - 3, [batch], "batch")
        assign(nd - 1, [_MODEL_AXIS], "channels")
    elif key == "state":  # (..., B, H, P, N)
        assign(nd - 4, [batch], "batch")
        assign(nd - 3, [_MODEL_AXIS], "heads")
    else:  # unknown leaf: batch-shard dim 0 if it fits, replicate the rest
        assign(0, [batch], "batch")
    return P(*entries)


def cache_pspecs(cfg: ModelConfig, cache_struct, plan: ShardingPlan):
    """PartitionSpec tree for a decode cache (all model families)."""
    return _map_with_path(
        lambda parts, leaf: _cache_spec(plan, parts[-1] if parts else "", leaf.shape,
                                        ".".join(parts)),
        cache_struct,
    )


# ---------------------------------------------------------------------------
# input rules
# ---------------------------------------------------------------------------

def _input_spec(plan: ShardingPlan, parts: List[str], shape) -> P:
    nd = len(shape)
    if nd == 0:
        return P()
    entries: List[Optional[Candidate]] = [None] * nd
    if plan.batch_axes:
        entries[0] = plan.pick(
            shape[0], [plan.batch_axes], set(), ".".join(parts) + ".batch"
        )
    return P(*entries)


def input_pspecs(cfg: ModelConfig, input_specs, plan: ShardingPlan):
    """Batch rule for step-function inputs: dim 0 spans the batch axes (with
    divisibility fallback, e.g. the global_batch=1 long-context cell stays
    replicated). A nested ``cache`` subtree uses the cache rules instead."""

    def rule(parts, leaf):
        if "cache" in parts:
            return _cache_spec(plan, parts[-1], leaf.shape, ".".join(parts))
        return _input_spec(plan, parts, leaf.shape)

    return _map_with_path(rule, input_specs)


# ---------------------------------------------------------------------------
# placement on a DeviceMesh
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Sequence, mesh) -> Tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim: Shard(i)
    where the dim's name is in entry i, else Replicate(). A joint entry must
    name its axes in mesh order (the reference's are its batch axes)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axes(mesh))
    out: List = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        axes = _entry_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} does not follow the mesh order {names}")
        for j in idx:
            out[j] = Shard(i)
    return tuple(out)


def spec_of(placements_: Sequence, mesh) -> P:
    """The inverse of `placements`: the spec of a tensor of ``ndim`` dims
    (the largest shard dim + 1 at least) placed by ``placements_``."""
    names = list(mesh_axes(mesh))
    by_dim: Dict[int, List[str]] = {}
    for name, pl in zip(names, placements_, strict=True):
        if pl.is_shard():
            by_dim.setdefault(pl.dim, []).append(name)
    nd = max(by_dim, default=-1) + 1
    return P(*(tuple(by_dim[i]) if i in by_dim else None for i in range(nd)))


def shard_shape(shape: Sequence[int], spec: Sequence, mesh) -> Tuple[int, ...]:
    """One rank's shard of a tensor of ``shape`` placed by ``spec`` (every
    sharded dim divides: `ShardingPlan.pick` grants no other)."""
    sizes = mesh_axes(mesh)
    out = list(shape)
    for i, entry in enumerate(spec):
        n = math.prod(sizes[a] for a in _entry_axes(entry))
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split {n} ways ({entry!r})")
        out[i] //= n
    return tuple(out)


def shard_bytes(tree, specs, mesh) -> int:
    """Bytes of one rank's shards of every leaf of ``tree`` placed by
    ``specs`` (the per-rank argument bytes of the dry-run)."""
    leaves, ss = _leaves(tree), tree_specs(specs)
    return sum(math.prod(shard_shape(t.shape, s, mesh)) * t.element_size()
               for t, s in zip(leaves, ss, strict=True))


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [tree]


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a device mesh (JAX's ``NamedSharding``): what
    `train_step`'s ``grad_shardings`` and ``micro_shardings`` hold."""

    mesh: object  # DeviceMesh
    spec: P

    @property
    def placements(self) -> Tuple:
        return placements(self.spec, self.mesh)


def named(mesh, specs):
    """A tree of `NamedSharding` from a spec tree (the reference's ``_ns``)."""
    if isinstance(specs, dict):
        return {k: named(mesh, v) for k, v in specs.items()}
    return NamedSharding(mesh, specs)


def distribute(tree, specs, mesh):
    """Place every leaf of ``tree`` on ``mesh`` by its spec: a DTensor
    holding this rank's shard. Each rank slices its shard out of its own
    copy (``src_data_rank=None``: no communication), so every rank must
    hold the same tree, as one seeded draw gives."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        return {k: distribute(v, specs[k], mesh) for k, v in tree.items()}
    return distribute_tensor(tree, mesh, placements(specs, mesh), src_data_rank=None)
