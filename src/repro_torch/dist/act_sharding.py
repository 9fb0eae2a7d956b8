"""Activation sharding constraints, scoped by an explicit context (port of
``repro.dist.act_sharding``).

The model trunks call ``constrain_batch`` on every embedded activation so
that, under a mesh, the batch dim stays distributed instead of being
re-gathered between layers: a DTensor activation is redistributed to
``Shard(0)`` on the context's batch axes, its other placements left as
they are but for a pending sum, which is reduced. Outside a
``use_activation_sharding`` context (single-device tests, the serving
engine) the call is an *exact* no-op: it returns its argument itself, and
so it does for a plain tensor and for a batch the batch axes do not
divide.

Usage (launch/dryrun.py, launch/elastic.py):

    plan = ShardingPlan(mesh)
    with use_activation_sharding(mesh, plan.batch_axes):
        model.decode(params, tokens, positions, cache)
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import List, Tuple

import torch

from repro_torch.dist.sharding import mesh_axes

# Stack of (mesh, batch_axes): supports nested/elastic contexts and restores
# the prior state on exit (including on exceptions).
_ACTIVE: List[Tuple[object, Tuple[str, ...]]] = []


def active_context():
    """The innermost (mesh, batch_axes) context, or None. Test/debug hook."""
    return _ACTIVE[-1] if _ACTIVE else None


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """Redistribute dim 0 of a DTensor ``x`` over the active context's batch
    axes.

    Returns ``x`` itself when no context is active, when ``x`` is a plain
    tensor, when the context has no batch axes, or when the batch dim is not
    divisible by the batch-axes extent (the divisibility-fallback rule:
    replicate rather than force an uneven shard)."""
    if not _ACTIVE:
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    mesh, batch_axes = _ACTIVE[-1]
    if not batch_axes:
        return x
    sizes = mesh_axes(mesh)
    n = math.prod(sizes[a] for a in batch_axes)
    if n <= 0 or x.ndim == 0 or x.shape[0] % n != 0:
        return x
    names = list(sizes)
    # a pending sum (the lookup of a vocab-sharded embedding) is settled
    # here: its mask does not survive splitting the batch under it
    want = [Replicate() if p.is_partial() else p for p in x.placements]
    for a in batch_axes:
        want[names.index(a)] = Shard(0)
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


@contextmanager
def use_activation_sharding(mesh, batch_axes):
    """Activate batch-axis activation sharding for calls under this scope."""
    if isinstance(batch_axes, str):
        batch_axes = (batch_axes,)
    _ACTIVE.append((mesh, tuple(batch_axes)))
    try:
        yield
    finally:
        _ACTIVE.pop()
