"""Training step with gradient accumulation (microbatching), a port of
``repro.training.train_step``.

The reference scans over microbatches inside one compiled step; here a
Python loop runs forward and backward per microbatch (`torch.autograd.grad`
on the parameter tensors) and accumulates f32 gradients, in the
reference's arithmetic.

On a mesh (DTensor parameters) the reference's two constraints are kept:
``grad_shardings`` lays each gradient and the f32 accumulator out as its
parameter (`_constrain`: a redistribution, where the reference pins a
sharding), and ``micro_shardings`` lays each microbatch out over the batch
axes. A microbatch is the reference's row group, rows i·B/n to
(i+1)·B/n − 1 of the global batch, and only then split over the batch
axes: splitting each rank's local rows instead would put other rows in
microbatch i, whose loss is a mean over other valid labels. Both trees hold
`dist.sharding.NamedSharding`s (None: left as it is).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.dtensor import is_dtensor, mixed, to_placements
from repro_torch.models.model import Model
from repro_torch.training.optimizer import (
    OptimizerConfig,
    OptState,
    adamw_update,
    shards,
    slices,
    tree_leaves,
    tree_map,
    tree_unflatten,
    zeros_f32,
)
from repro_torch.roofline import op_stats


def _split_batch(batch: Dict, n_micro: int):
    """(B, ...) -> n_micro dicts of (B/n_micro, ...) for every leaf: rows
    i·B/n to (i+1)·B/n − 1. A DTensor leaf is gathered whole first (a
    collective), so microbatch i holds the same rows as on one device."""
    for name, x in batch.items():
        if x.shape[0] % n_micro:
            raise ValueError(f"batch {name}: {x.shape[0]} rows do not split into {n_micro} "
                             "microbatches")
    whole = {k: x.full_tensor() if is_dtensor(x) else x for k, x in batch.items()}
    return [{k: x.chunk(n_micro)[i] for k, x in whole.items()} for i in range(n_micro)]


def _constrain(tree, shardings):
    """Each leaf laid out by its `NamedSharding` (the reference's
    ``with_sharding_constraint``); None leaves it as it is."""
    if shardings is None:
        return tree
    if isinstance(tree, dict):
        return {k: _constrain(v, shardings[k]) for k, v in tree.items()}
    return to_placements(tree, shardings.mesh, shardings.placements)


def _value_and_grad(model: Model, params: Dict, batch: Dict) -> Tuple[torch.Tensor, Dict]:
    """(loss, grads in each parameter's dtype): the loss's gradient with
    respect to aliases of the parameters (no copy). A parameter the loss
    does not use (the token embedding of a model fed embeddings, with its
    own head) gets zeros, as under ``jax.grad``."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad(), mixed(params):  # the recomputation of remat runs in the backward
        loss = model.loss(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads, strict=True)]
    loss = loss.detach()
    return (loss.full_tensor() if is_dtensor(loss) else loss), tree_unflatten(params, grads)


def loss_and_grad_accum(
    model: Model, params: Dict, batch: Dict, n_micro: int, grad_shardings=None,
    micro_shardings=None,
) -> Tuple[torch.Tensor, Dict]:
    """Mean loss + grads accumulated over microbatches: each microbatch's
    grads enter an f32 accumulator as ``g.float() / n_micro``, and its loss
    as ``loss / n_micro``, as in the reference's scan (a slice of a leaf at
    a time, `optimizer.slices`). ``grad_shardings`` lays the gradients and
    the accumulator out, ``micro_shardings`` each microbatch (module
    docstring)."""
    if n_micro <= 1:
        loss, grads = _value_and_grad(model, params, _constrain(batch, micro_shardings))
        return loss, _constrain(grads, grad_shardings)
    loss_acc = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
    grad_acc = _constrain(tree_map(zeros_f32, params), grad_shardings)
    for mb in _split_batch(batch, n_micro):
        loss, grads = _value_and_grad(model, params, _constrain(mb, micro_shardings))
        grads = _constrain(grads, grad_shardings)
        for leaf in zip(tree_leaves(grad_acc), tree_leaves(grads), strict=True):
            if is_dtensor(leaf[0]) and tuple(leaf[1].placements) != tuple(leaf[0].placements):
                leaf = (leaf[0], to_placements(leaf[1], leaf[0].device_mesh, leaf[0].placements))
            with op_stats.scaled(shards(leaf[0])):
                for a, g in slices(*leaf):
                    a.copy_(a + g.float() / n_micro)
        del grads
        loss_acc = loss_acc + loss / n_micro
    return loss_acc, grad_acc


def make_train_step(model: Model, opt_cfg: OptimizerConfig, n_micro: int = 1,
                    grad_shardings=None, micro_shardings=None):
    """Returns train_step(params, opt_state, batch) -> (params', opt_state',
    metrics). ``batch`` holds tensors on the parameters' device; params' and
    the moments are the tensors passed in, updated in place
    (`optimizer.adamw_update`). On a mesh, ``grad_shardings`` and
    ``micro_shardings`` as the reference's (module docstring)."""

    def train_step(params: Dict, opt_state: OptState, batch: Dict):
        loss, grads = loss_and_grad_accum(model, params, batch, n_micro, grad_shardings,
                                          micro_shardings)
        params2, opt2, metrics = adamw_update(opt_cfg, params, grads, opt_state)
        metrics["loss"] = loss
        return params2, opt2, metrics

    return train_step


def default_microbatches(cfg: ModelConfig, global_batch: int) -> int:
    """Pick a microbatch count so per-microbatch logits stay ~<=64 MB/device
    at the production mesh (heuristic; overridable via TrainConfig)."""
    if global_batch >= 256:
        return 8
    if global_batch >= 64:
        return 4
    return 1
