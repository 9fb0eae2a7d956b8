"""Plain PyTorch version of the chunked-prefill attention kernel: the same
function as ``repro.kernels.prefill_attention.ref.prefill_attention_ref``."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -0.7 * torch.finfo(torch.float32).max


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
    b, sq, hq, dh = q.shape
    rep = hq // k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if logit_cap > 0.0:
        s = logit_cap * torch.tanh(s / logit_cap)
    kvp = torch.arange(k.shape[1], device=q.device)
    mask = (kvp[None, None, :] <= q_pos[:, :, None]) & (
        kvp[None, None, :] < kv_len[:, None, None]
    )
    s = torch.where(mask[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(q.dtype)
