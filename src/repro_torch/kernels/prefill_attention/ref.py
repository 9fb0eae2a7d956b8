"""Plain PyTorch versions of the chunked-prefill attention kernels: the
forward is the same function as ``repro.kernels.prefill_attention.ref.
prefill_attention_ref``; `prefill_attention_lse` gives the row log-sum-exp
the forward kernels write for the backward; `prefill_attention_bwd_ref` is
the backward kernels' plain version, written out (not autograd), the
gradient the reference gets from XLA's autodiff of its plain attention."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -0.7 * torch.finfo(torch.float32).max


def _scores(q, k, q_pos, kv_len, scale, logit_cap):
    """(capped scores (B, Hq, Sq, Skv) f32 with masked entries at NEG_INF,
    the mask (B, 1, Sq, Skv)), K repeated over the query heads of a group."""
    rep = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if logit_cap > 0.0:
        s = logit_cap * torch.tanh(s / logit_cap)
    kvp = torch.arange(k.shape[1], device=q.device)
    mask = (kvp[None, None, :] <= q_pos[:, :, None]) & (
        kvp[None, None, :] < kv_len[:, None, None]
    )
    return torch.where(mask[:, None], s, NEG_INF), mask[:, None]


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def prefill_attention_ref(
    q: torch.Tensor,  # (B, Sq, Hq, Dh)
    k: torch.Tensor,  # (B, Skv, Hkv, Dh)
    v: torch.Tensor,
    q_pos: torch.Tensor,  # (B, Sq)
    kv_len: torch.Tensor,  # (B,)
    *,
    scale: Optional[float] = None,
    logit_cap: float = 0.0,
) -> torch.Tensor:
    rep = q.shape[2] // k.shape[2]
    s, _ = _scores(q, k, q_pos, kv_len, _scale(q, scale), logit_cap)
    p = torch.softmax(s, dim=-1)
    v = v.repeat_interleave(rep, dim=2)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(q.dtype)


def prefill_attention_lse(
    q: torch.Tensor, k: torch.Tensor, q_pos: torch.Tensor, kv_len: torch.Tensor, *,
    scale: Optional[float] = None, logit_cap: float = 0.0,
) -> torch.Tensor:
    """The log-sum-exp of each query row's masked, capped scores, (B, Hq, Sq)
    f32 (natural log): what the forward kernels write beside the output."""
    s, _ = _scores(q, k, q_pos, kv_len, _scale(q, scale), logit_cap)
    return torch.logsumexp(s, dim=-1)


def prefill_attention_bwd_ref(
    q: torch.Tensor,  # (B, Sq, Hq, Dh)
    k: torch.Tensor,  # (B, Skv, Hkv, Dh)
    v: torch.Tensor,
    out: torch.Tensor,  # (B, Sq, Hq, Dh), the forward's output
    lse: torch.Tensor,  # (B, Hq, Sq) f32, the forward's log-sum-exp
    dout: torch.Tensor,  # (B, Sq, Hq, Dh)
    q_pos: torch.Tensor,
    kv_len: torch.Tensor,
    *,
    scale: Optional[float] = None,
    logit_cap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the inputs' dtype, computed in f32: P recomputed from
    ``lse`` (0 where masked), ``D = rowsum(dO * O)``, ``dS = P * (dP - D)``
    with ``dP = dO V^T``, the cap's chain factor ``1 - (s / cap)^2``, and dK,
    dV summed over the query heads of each KV head's group. P is rounded to
    v's dtype before ``dV = P^T dO``, where the forward rounds it before
    ``P V``."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    sc = _scale(q, scale)
    s, mask = _scores(q, k, q_pos, kv_len, sc, logit_cap)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)  # (B, Hq, Sq, Skv)
    do = dout.float()
    vr = v.float().repeat_interleave(rep, dim=2)
    kr = k.float().repeat_interleave(rep, dim=2)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vr)
    d = (do * out.float()).sum(-1).transpose(1, 2)  # (B, Hq, Sq)
    ds = p * (dp - d[..., None])
    if logit_cap > 0.0:  # masked entries hold NEG_INF, whose square overflows
        ds = ds * torch.where(mask, 1.0 - (s / logit_cap) ** 2, 0.0)
    ds = ds * sc
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype).float(), do)
    dk = dk.reshape(b, skv, hkv, rep, dh).sum(3)
    dv = dv.reshape(b, skv, hkv, rep, dh).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
