"""Plain PyTorch version of the GQA decode attention kernel: the same
function as ``repro.kernels.decode_attention.ref.decode_attention_ref``."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -0.7 * torch.finfo(torch.float32).max


def decode_attention_ref(
    q: torch.Tensor,  # (B, Hq, Dh), one token per sequence
    k: torch.Tensor,  # (B, S, Hkv, Dh)
    v: torch.Tensor,
    kv_len: torch.Tensor,  # (B,)
    *,
    scale: Optional[float] = None,
    logit_cap: float = 0.0,
) -> torch.Tensor:
    b, hq, dh = q.shape
    rep = hq // k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k.float()) * scale
    if logit_cap > 0.0:
        s = logit_cap * torch.tanh(s / logit_cap)
    kvp = torch.arange(k.shape[1], device=q.device)
    mask = kvp[None, None, :] < kv_len[:, None, None]
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", p.to(v.dtype), v).to(q.dtype)
