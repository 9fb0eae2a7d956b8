"""Token-choice top-k MoE with capacity and grouped one-hot dispatch, in
PyTorch (port of ``repro.models.moe``).

GShard/MaxText-style dense dispatch, as in the reference: tokens are split
into groups; within a group each token picks its top-k experts; positions
within an expert are assigned by cumulative sum with the k = 0 choices
first; tokens past an expert's capacity are dropped (their combine weight
is zero and the residual stream carries them). Every token of the input
takes part in routing, padding rows included, so they use up capacity
exactly as in the reference. Dispatch, the expert products and combine are
einsums (``torch.einsum``), which the reference also computes outside any
kernel.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import act_fn, dense_init


def init_moe_params(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
                    device: torch.device) -> Dict:
    """One layer's experts with the reference's distributions; the router
    stays f32 whatever ``dtype`` is."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return dict(
        router=dense_init(gen, (d, e), torch.float32, device),
        w_gate=dense_init(gen, (e, d, f), dtype, device),
        w_up=dense_init(gen, (e, d, f), dtype, device),
        w_down=dense_init(gen, (e, f, d), dtype, device, in_axis=1),
    )


def _top_k(gates: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort keeps equal values in order)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot`` in f32: an index outside [0, n) gives a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _route(x2: torch.Tensor, router: torch.Tensor, k: int):
    """Normalised top-k gate values and expert ids of each row of x2."""
    gates = torch.softmax(x2.float() @ router, dim=-1)
    topv, topi = _top_k(gates, k)
    return topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9), topi


def moe_ffn(x: torch.Tensor, params: Dict, cfg: ModelConfig) -> torch.Tensor:
    """x: (..., d_model) -> (..., d_model). Flattens the leading dims into
    groups of ``min(moe_group_size, tokens)`` rows, the last padded."""
    orig_shape = x.shape
    d = orig_shape[-1]
    x2 = x.reshape(-1, d)
    tokens = x2.shape[0]
    gs = min(cfg.moe_group_size, tokens)
    ngroups = -(-tokens // gs)
    pad = ngroups * gs - tokens
    if pad:
        x2 = F.pad(x2, (0, 0, 0, pad))
    xg = x2.reshape(ngroups, gs, d)

    e, k = cfg.num_experts, cfg.experts_per_token
    cap = cfg.moe_capacity(gs)
    topv, topi = _route(xg, params["router"], k)  # (g, s, k)

    onehot = _one_hot(topi, e)  # (g, s, k, e)
    # position within expert: cumulate over the choices in (k, s) order so
    # the k = 0 choices get the earlier slots
    oh_ks = onehot.transpose(1, 2).reshape(ngroups, k * gs, e)
    pos_ks = torch.cumsum(oh_ks, dim=1) - oh_ks
    pos = pos_ks.reshape(ngroups, k, gs, e).transpose(1, 2)  # (g, s, k, e)
    within_cap = (pos < cap) & (onehot > 0)

    pos_idx = (pos * onehot).sum(-1).long()  # (g, s, k)
    cap_oh = _one_hot(pos_idx, cap)  # (g, s, k, c)
    keep = within_cap.any(-1)  # (g, s, k)

    dispatch = torch.einsum("gske,gskc->gsec", onehot * within_cap.float(), cap_oh)
    combine = torch.einsum("gske,gskc->gsec", onehot * (topv * keep.float())[..., None], cap_oh)

    xdtype = x.dtype
    expert_in = torch.einsum("gsec,gsd->gecd", dispatch.to(xdtype), xg)
    g_act = act_fn(cfg.act)(torch.einsum("gecd,edf->gecf", expert_in, params["w_gate"]))
    u = torch.einsum("gecd,edf->gecf", expert_in, params["w_up"])
    expert_out = torch.einsum("gecf,efd->gecd", g_act * u, params["w_down"])
    yg = torch.einsum("gsec,gecd->gsd", combine.to(xdtype), expert_out)
    return yg.reshape(ngroups * gs, d)[:tokens].reshape(orig_shape)


def moe_ffn_ref(x: torch.Tensor, params: Dict, cfg: ModelConfig) -> torch.Tensor:
    """Oracle: every expert densely, no capacity drop. With a capacity factor
    large enough that nothing is dropped, ``moe_ffn`` equals this."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    topv, topi = _route(x2, params["router"], cfg.experts_per_token)
    y = torch.zeros_like(x2)
    for e in range(cfg.num_experts):
        g = act_fn(cfg.act)(x2 @ params["w_gate"][e])
        u = x2 @ params["w_up"][e]
        out_e = (g * u) @ params["w_down"][e]
        w_e = torch.where(topi == e, topv, 0.0).sum(-1)
        y = y + out_e * w_e[:, None].to(x2.dtype)
    return y.reshape(shape)
