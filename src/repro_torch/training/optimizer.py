"""Optimizer: AdamW with WSD (warmup-stable-decay) schedule (MiniCPM-style),
a port of ``repro.training.optimizer``.

States are explicit trees like the parameters (f32 ``m``/``v``), computed
in f32 as the reference computes them. Unlike the reference, which returns
new arrays, `adamw_update` updates the parameters and the moments in place
and returns the same tensors: a second copy of the f32 moments would not
fit beside the model on one card at minicpm-2b's size.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Tuple

import torch


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


def init_opt_state(params) -> OptState:
    dev = tree_leaves(params)[0].device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
    )


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(
    cfg: OptimizerConfig, params, grads, state: OptState
) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step with grad clipping + WSD LR, in place. Returns
    (params, state', metrics): ``params`` and the moments are the tensors
    passed in, updated; the step counter is a new tensor."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = wsd_schedule(cfg, state.step)
    b1, b2 = cfg.betas
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
                          tree_leaves(state.v), strict=True):
        g = g.float() * scale
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    return params, OptState(step=step, m=state.m, v=state.v), dict(grad_norm=gnorm, lr=lr)
