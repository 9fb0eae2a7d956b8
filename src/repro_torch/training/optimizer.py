"""Optimizer: AdamW with WSD (warmup-stable-decay) schedule (MiniCPM-style),
a port of ``repro.training.optimizer``.

States are explicit trees like the parameters (f32 ``m``/``v``), computed
in f32 as the reference computes them. Unlike the reference, which returns
new arrays, `adamw_update` updates the parameters and the moments in place
and returns the same tensors: a second copy of the f32 moments would not
fit beside the model on one card at minicpm-2b's size. For the same reason
each leaf is updated in slices of at most `SLICE` elements (`slices`): the
arithmetic is the same element by element, but its f32 temporaries stay
small where one stacked weight is large (zamba2-2.7b's in_proj stack holds
1.4e9 parameters, 5.8 GB per f32 temporary).

On a mesh (DTensor parameters) every leaf is updated on each rank's own
shard: the gradient is laid out as its parameter first (the moments are
made with its placements), `slices` takes the local tensors, and
`global_norm` is still the norm of the whole gradient (each leaf's local
sum of squares summed over the ranks that hold distinct shards).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.dist.dtensor import is_dtensor, to_placements
from repro_torch.roofline import op_stats


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # WSD schedule
    warmup_steps: int = 100
    stable_steps: int = 1000
    decay_steps: int = 100
    min_lr_frac: float = 0.1


SLICE = 1 << 26  # elements of one slice of a leaf: 256 MB per f32 temporary


def slices(*tensors: torch.Tensor):
    """Matching 1-D views of at most `SLICE` elements of tensors of one
    shape, in order, so that an elementwise update runs a slice at a time;
    the tensors whole where one is not contiguous. DTensors of one layout
    give views of their local shards (``view(-1)`` of a sharded DTensor may
    be refused)."""
    if is_dtensor(tensors[0]):
        if len({tuple(t.placements) for t in tensors}) > 1:
            raise ValueError("slices: DTensors placed differently")
        tensors = tuple(t.to_local() for t in tensors)
    if not all(t.is_contiguous() for t in tensors):
        yield tensors
        return
    flat = [t.view(-1) for t in tensors]
    for i in range(0, flat[0].numel(), SLICE):
        yield tuple(f[i:i + SLICE] for f in flat)


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: Any  # tree like params (f32)
    v: Any  # tree like params (f32)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, in sorted key order (JAX's order)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` in `tree_leaves`'s order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def wsd_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Warmup -> stable -> (cosine-free) linear decay to min_lr_frac."""
    s = step.float()
    warm = cfg.lr * (s + 1.0) / max(1, cfg.warmup_steps)
    stable = torch.tensor(cfg.lr, dtype=torch.float32, device=s.device)
    t = (s - cfg.warmup_steps - cfg.stable_steps) / max(1, cfg.decay_steps)
    t = torch.clamp(t, 0.0, 1.0)
    decay = cfg.lr * (1.0 - (1.0 - cfg.min_lr_frac) * t)
    return torch.where(s < cfg.warmup_steps, warm, torch.where(t > 0, decay, stable))


def zeros_f32(p: torch.Tensor) -> torch.Tensor:
    """f32 zeros of ``p``'s shape on its device (and mesh, with its
    placements, for a DTensor)."""
    if is_dtensor(p):
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def init_opt_state(params) -> OptState:
    dev = tree_leaves(params)[0].device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m=tree_map(zeros_f32, params),
        v=tree_map(zeros_f32, params),
    )


def shards(t: torch.Tensor) -> int:
    """Distinct shards of a DTensor (the mesh sizes of its sharded dims); 1
    for a plain tensor."""
    if not is_dtensor(t):
        return 1
    return math.prod(n for n, p in zip(t.device_mesh.shape, t.placements, strict=True)
                     if p.is_shard())


def _sq_sum(g: torch.Tensor) -> torch.Tensor:
    with op_stats.scaled(shards(g)):
        return sum(torch.sum(torch.square(s.float())) for (s,) in slices(g))


def global_norm(tree) -> torch.Tensor:
    """The norm of the whole tree. Leaves of one DTensor layout are summed
    locally, then over the ranks holding distinct shards (a sum over the
    sharded mesh dims, one reduction per layout)."""
    plain, placed = [], {}
    for g in tree_leaves(tree):
        if is_dtensor(g):
            if any(p.is_partial() for p in g.placements):
                raise ValueError("global_norm: a leaf holds a pending sum (Partial); lay it out "
                                 "as its parameter first")
            key = (g.device_mesh, tuple(p.is_shard() for p in g.placements))
            placed[key] = placed.get(key, 0) + _sq_sum(g)
        else:
            plain.append(_sq_sum(g))
    total = sum(plain)
    for (mesh, sharded), local in placed.items():
        pl = [Partial() if s else Replicate() for s in sharded]
        total = total + DTensor.from_local(local, mesh, pl, run_check=False).full_tensor()
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(
    cfg: OptimizerConfig, params, grads, state: OptState
) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step with grad clipping + WSD LR, in place. Returns
    (params, state', metrics): ``params`` and the moments are the tensors
    passed in, updated; the step counter is a new tensor. A DTensor
    gradient is first laid out as its parameter (a pending sum, Partial,
    is settled), so the norm and each update see the whole gradient."""
    grads = tree_unflatten(params, [
        to_placements(g, p.device_mesh, p.placements) if is_dtensor(p) else g
        for p, g in zip(tree_leaves(params), tree_leaves(grads), strict=True)])
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = wsd_schedule(cfg, state.step)
    b1, b2 = cfg.betas
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    leaves = zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
                 tree_leaves(state.v), strict=True)
    for leaf in leaves:
        with op_stats.scaled(shards(leaf[0])):
            for p, g, m, v in slices(*leaf):
                g = g.float() * scale
                m.copy_(b1 * m + (1 - b1) * g)
                v.copy_(b2 * v + (1 - b2) * torch.square(g))
                mhat = m / bc1
                vhat = v / bc2
                delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
                p.copy_(p.float() - lr * delta)
    return params, OptState(step=step, m=state.m, v=state.v), dict(grad_norm=gnorm, lr=lr)
