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

On DTensors (a model on a mesh) the layer runs through ``local_map``
(`_moe_on_mesh`): each rank routes its own rows, whole groups of them, and
computes every expert on its slice of the expert width.

While a ``torch.profiler`` runs, each call of the layer opens four ranges,
``moe.route``, ``moe.dispatch``, ``moe.experts`` and ``moe.combine``, so a
device trace can put the layer's kernels down to its phases; otherwise it
opens none.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.dtensor import is_dtensor, kernel_map, to_placements
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


_NO_RANGE = contextlib.nullcontext()


def _range(name: str, on: bool):
    """A profiler range named ``name`` if ``on`` (a profiler runs)."""
    return record_function(name) if on else _NO_RANGE


def moe_ffn(x: torch.Tensor, params: Dict, cfg: ModelConfig) -> torch.Tensor:
    """x: (..., d_model) -> (..., d_model). Flattens the leading dims into
    groups of ``min(moe_group_size, tokens)`` rows, the last padded."""
    if is_dtensor(x):
        return _moe_on_mesh(x, params, cfg)
    return _moe_local(x, params, cfg, min(cfg.moe_group_size, math.prod(x.shape[:-1])))


def _moe_local(x: torch.Tensor, params: Dict, cfg: ModelConfig, gs: int) -> torch.Tensor:
    """`moe_ffn` on tensors, in groups of ``gs`` rows."""
    orig_shape = x.shape
    d = orig_shape[-1]
    x2 = x.reshape(-1, d)
    tokens = x2.shape[0]
    ngroups = -(-tokens // gs)
    pad = ngroups * gs - tokens
    if pad:
        x2 = F.pad(x2, (0, 0, 0, pad))
    xg = x2.reshape(ngroups, gs, d)

    e, k = cfg.num_experts, cfg.experts_per_token
    cap = cfg.moe_capacity(gs)
    ranged = torch.autograd._profiler_enabled()
    with _range("moe.route", ranged):
        topv, topi = _route(xg, params["router"], k)  # (g, s, k)

    with _range("moe.dispatch", ranged):
        onehot = _one_hot(topi, e)  # (g, s, k, e)
        # position within expert: cumulate over the choices in (k, s) order
        # so the k = 0 choices get the earlier slots
        oh_ks = onehot.transpose(1, 2).reshape(ngroups, k * gs, e)
        pos_ks = torch.cumsum(oh_ks, dim=1) - oh_ks
        pos = pos_ks.reshape(ngroups, k, gs, e).transpose(1, 2)  # (g, s, k, e)
        within_cap = (pos < cap) & (onehot > 0)

        pos_idx = (pos * onehot).sum(-1).long()  # (g, s, k)
        cap_oh = _one_hot(pos_idx, cap)  # (g, s, k, c)
        keep = within_cap.any(-1)  # (g, s, k)

        dispatch = torch.einsum("gske,gskc->gsec", onehot * within_cap.float(), cap_oh)
        combine = torch.einsum("gske,gskc->gsec", onehot * (topv * keep.float())[..., None],
                               cap_oh)

        xdtype = x.dtype
        expert_in = torch.einsum("gsec,gsd->gecd", dispatch.to(xdtype), xg)
    with _range("moe.experts", ranged):
        g_act = act_fn(cfg.act)(torch.einsum("gecd,edf->gecf", expert_in, params["w_gate"]))
        u = torch.einsum("gecd,edf->gecf", expert_in, params["w_up"])
        expert_out = torch.einsum("gecf,efd->gecd", g_act * u, params["w_down"])
    with _range("moe.combine", ranged):
        yg = torch.einsum("gsec,gecd->gsd", combine.to(xdtype), expert_out)
    return yg.reshape(ngroups * gs, d)[:tokens].reshape(orig_shape)


def _moe_on_mesh(x, params: Dict, cfg: ModelConfig):
    """`moe_ffn` on DTensors through ``local_map``. The rows stay split over
    the batch mesh dims where each rank holds whole groups of the
    reference's grouping (else every rank routes every row); the expert
    width F is split over the mesh dim that splits ``w_gate``'s (the plan's
    tensor-parallel axis), ``w_down`` laid out on the same F slices (the
    plan splits it on d_model where d_model = heads x head_dim, so that is
    a redistribution of the weight per call, which the collective count
    shows), and each rank's output is its F slice's share of the sum
    (Partial). Under an op count (meta tensors) the layer is counted once
    at its global shapes."""
    mesh = x.device_mesh
    tokens = math.prod(x.shape[:-1])
    gs = min(cfg.moe_group_size, tokens)
    n, batch = 1, []
    for j, p in enumerate(x.placements):
        if p == Shard(0) and x.shape[0] % (n * mesh.shape[j]) == 0:
            n *= mesh.shape[j]
            batch.append(j)
    if (tokens // n) % gs:
        n, batch = 1, []  # a rank's rows would cut a group: keep the rows whole
    fdim = next((j for j, p in enumerate(params["w_gate"].placements)
                 if p == Shard(2) and j not in batch), None)

    def place(batch_at=None, f_at=None, partial_batch=False, partial_f=False):
        pl = [Replicate()] * mesh.ndim
        for j in batch:
            if partial_batch:
                pl[j] = Partial()
            elif batch_at is not None:
                pl[j] = Shard(batch_at)
        if fdim is not None and (f_at is not None or partial_f):
            pl[fdim] = Partial() if partial_f else Shard(f_at)
        return tuple(pl)

    names = ("router", "w_gate", "w_up", "w_down")
    xp, outp = place(0), place(0, partial_f=True)
    wps = (place(), place(f_at=2), place(f_at=2), place(f_at=1))
    ops = [to_placements(x, mesh, xp),
           *(to_placements(params[k], mesh, p) for k, p in zip(names, wps, strict=True))]
    grads = (place(0, partial_f=True), place(partial_batch=True, partial_f=True),
             place(f_at=2, partial_batch=True), place(f_at=2, partial_batch=True),
             place(f_at=1, partial_batch=True))
    return kernel_map(lambda t, *w: _moe_local(t, dict(zip(names, w, strict=True)), cfg, gs),
                      lambda t, *w: moe_ffn(t, dict(zip(names, w, strict=True)), cfg),
                      mesh, ops, grads, [(tuple(x.shape), x.dtype, outp)])


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
