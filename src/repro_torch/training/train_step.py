"""Training step with gradient accumulation (microbatching), a port of
``repro.training.train_step``.

The reference scans over microbatches inside one compiled step; here a
Python loop runs forward and backward per microbatch (`torch.autograd.grad`
on the parameter tensors) and accumulates f32 gradients, in the
reference's arithmetic. The reference's ``grad_shardings`` and
``micro_shardings`` pin shardings on a device mesh; the port has no mesh
yet (ROADMAP A11), so they have no counterpart here.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model
from repro_torch.training.optimizer import (
    OptimizerConfig,
    OptState,
    adamw_update,
    slices,
    tree_leaves,
    tree_map,
    tree_unflatten,
)


def _split_batch(batch: Dict, n_micro: int):
    """(B, ...) -> n_micro dicts of (B/n_micro, ...) for every leaf."""
    for name, x in batch.items():
        if x.shape[0] % n_micro:
            raise ValueError(f"batch {name}: {x.shape[0]} rows do not split into {n_micro} "
                             "microbatches")
    return [{k: x.chunk(n_micro)[i] for k, x in batch.items()} for i in range(n_micro)]


def _value_and_grad(model: Model, params: Dict, batch: Dict) -> Tuple[torch.Tensor, Dict]:
    """(loss, grads in each parameter's dtype): the loss's gradient with
    respect to aliases of the parameters (no copy). A parameter the loss
    does not use (the token embedding of a model fed embeddings, with its
    own head) gets zeros, as under ``jax.grad``."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = model.loss(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads, strict=True)]
    return loss.detach(), tree_unflatten(params, grads)


def loss_and_grad_accum(
    model: Model, params: Dict, batch: Dict, n_micro: int
) -> Tuple[torch.Tensor, Dict]:
    """Mean loss + grads accumulated over microbatches: each microbatch's
    grads enter an f32 accumulator as ``g.float() / n_micro``, and its loss
    as ``loss / n_micro``, as in the reference's scan (a slice of a leaf at
    a time, `optimizer.slices`)."""
    if n_micro <= 1:
        return _value_and_grad(model, params, batch)
    loss_acc = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
    grad_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                        params)
    for mb in _split_batch(batch, n_micro):
        loss, grads = _value_and_grad(model, params, mb)
        for leaf in zip(tree_leaves(grad_acc), tree_leaves(grads), strict=True):
            for a, g in slices(*leaf):
                a.copy_(a + g.float() / n_micro)
        del grads
        loss_acc = loss_acc + loss / n_micro
    return loss_acc, grad_acc


def make_train_step(model: Model, opt_cfg: OptimizerConfig, n_micro: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params', opt_state',
    metrics). ``batch`` holds tensors on the parameters' device; params' and
    the moments are the tensors passed in, updated in place
    (`optimizer.adamw_update`)."""

    def train_step(params: Dict, opt_state: OptState, batch: Dict):
        loss, grads = loss_and_grad_accum(model, params, batch, n_micro)
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
