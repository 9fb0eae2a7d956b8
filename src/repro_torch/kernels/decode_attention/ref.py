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


SPLIT_ROWS = 256  # KV rows per split of the kernel (SPLIT in csrc/decode_attention.cu)


def decode_attention_split_ref(
    q: torch.Tensor,  # (B, Hq, Dh)
    k: torch.Tensor,  # (B, S, Hkv, Dh)
    v: torch.Tensor,
    kv_len: torch.Tensor,  # (B,)
    *,
    scale: Optional[float] = None,
    logit_cap: float = 0.0,
    split: int = SPLIT_ROWS,
) -> torch.Tensor:
    """The split-KV arithmetic of the kernel in plain PyTorch, for the
    tests: per split of ``split`` rows below kv_len, the max m, the sum l
    and the unnormalised accumulator of probabilities rounded to the value
    dtype; then the splits merged in order, each rescaled by exp(m_s - m).
    The same function as `decode_attention_ref`; nothing on the main path
    calls it."""
    b, hq, dh = q.shape
    rep = hq // k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    out = torch.empty_like(q)
    for i in range(b):
        n = int(min(int(kv_len[i]), k.shape[1]))
        kk = k[i, :n].repeat_interleave(rep, dim=1).float()  # (n, Hq, Dh)
        vv = v[i, :n].repeat_interleave(rep, dim=1)
        parts = []
        for j0 in range(0, n, split):
            s = torch.einsum("hd,khd->hk", q[i].float(), kk[j0:j0 + split]) * scale
            if logit_cap > 0.0:
                s = logit_cap * torch.tanh(s / logit_cap)
            m = s.max(dim=-1).values  # (Hq,)
            p = torch.exp(s - m[:, None])
            acc = torch.einsum("hk,khd->hd", p.to(v.dtype).float(), vv[j0:j0 + split].float())
            parts.append((m, p.sum(dim=-1), acc))
        m = torch.stack([pm for pm, _, _ in parts]).max(dim=0).values
        l = torch.zeros_like(m)
        acc = torch.zeros(hq, dh, dtype=torch.float32, device=q.device)
        for pm, pl, pa in parts:  # split order, as the combine kernel
            w = torch.exp(pm - m)
            l = l + pl * w
            acc = acc + pa * w[:, None]
        out[i] = (acc / l.clamp_min(1e-30)[:, None]).to(q.dtype)
    return out
