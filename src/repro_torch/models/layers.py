"""Neural-net layers of the decoder families, in PyTorch (port of
``repro.models.layers``).

Conventions, as in the JAX package
----------------------------------
- Weights live in ``cfg.dtype``; norms and softmax run in f32.
- Attention tensors are (batch, seq, heads, head_dim); weights are
  ``(in, out)`` as in ``x @ w``.
- Every layer is shape-polymorphic over batch and sequence, so the same code
  serves prefill (whole prompt), chunked prefill (chunk + cache) and decode
  (seq 1).

Attention dispatch: on the card the hand-written CUDA kernels are the path
for causal calls (Sq > 1 goes to the prefill kernel, Sq == 1 to the decode
kernel). On the CPU, ``impl="pallas"`` takes the kernels' wrappers (which
run their plain versions on CPU tensors) and ``"auto"``/``"naive"`` take
the plain paths: `naive_attention` below ``_NAIVE_ATTN_LIMIT`` query x KV
rows, `blockwise_attention` above it (``impl="blockwise"`` forces it
anywhere).

A sliding window can bind only when the KV length it is applied to exceeds
it (every ``kv_pos < Skv <= window`` satisfies ``kv_pos > q_pos - window``
for the queries of a cache of Skv rows), so a window that cannot bind is
dropped and the call takes the kernels; one that binds takes the plain
paths with the window in the mask, as every windowed call does in the
reference. The choice reads shapes only.

Non-causal attention (the encoder-decoder family's encoder and cross
attention) and packed segments follow the reference's dispatch: any
``q_seg`` forces the naive path; non-causal calls go naive or blockwise by
Sq x Skv. Non-causal calls with Sq > 1 stay on these plain paths on the
card too: the reference computes them outside any Pallas kernel as well,
so this is its own route, not a fallback. One route is the port's own: a
non-causal call with Sq == 1, no window and no ``q_seg`` goes to the decode
kernel with ``kv_len = kv_valid`` (Skv where ``kv_valid`` is None), since
that kernel masks only ``kv_pos < kv_len``, which is non-causal attention
for one query (the reference never calls that kernel; the port sends its
Sq == 1 causal calls there too).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist.dtensor import (
    Layout,
    batch_and_head_dims,
    is_dtensor,
    kernel_map,
    to_placements,
)
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.prefill_attention.ops import prefill_attention

_NEG_INF = -0.7 * torch.finfo(torch.float32).max
_NAIVE_ATTN_LIMIT = 8192 * 8192  # Sq x Skv above which the plain path goes blockwise
_KV_BLOCK = 1024  # KV rows per step of blockwise_attention

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ----------------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    orig = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(orig)


def gated_rms_norm(
    x: torch.Tensor, gate: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """Mamba2-style RMSNorm(x * silu(gate))."""
    orig = x.dtype
    x = x.float() * F.silu(gate.float())
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(orig)


# ----------------------------------------------------------------------------
# Rotary position embeddings
# ----------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Apply RoPE. x: (..., seq, heads, head_dim); positions: (..., seq)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(
        -math.log(theta) * (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    )
    angles = positions[..., None].float() * freqs  # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# Attention
# ----------------------------------------------------------------------------

def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return cap * torch.tanh(x / cap)
    return x


def attention_mask(
    q_pos: torch.Tensor,  # (B, Sq)
    kv_len: int,
    kv_valid: Optional[torch.Tensor] = None,  # (B,) valid kv length
    window: int = 0,  # 0 = no window
    causal: bool = True,
    q_seg: Optional[torch.Tensor] = None,  # (B, Sq) packed-segment ids
    kv_seg: Optional[torch.Tensor] = None,  # (B, Skv)
) -> torch.Tensor:
    """Boolean mask (B, Sq, Skv); True = attend. The segment test applies
    only when both ``q_seg`` and ``kv_seg`` are given, as in the reference."""
    kv_pos = torch.arange(kv_len, device=q_pos.device)[None, None, :]
    qp = q_pos[:, :, None]
    mask = torch.ones((q_pos.shape[0], q_pos.shape[1], kv_len), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask = mask & (kv_pos <= qp)
    if window:
        mask = mask & (kv_pos > qp - window)
    if kv_valid is not None:
        mask = mask & (kv_pos < kv_valid[:, None, None])
    if q_seg is not None and kv_seg is not None:
        mask = mask & (q_seg[:, :, None] == kv_seg[:, None, :])
    return mask


def naive_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,
    mask: torch.Tensor,  # (B, Sq, Skv) bool
    logit_cap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Grouped-head GQA attention (never materializes repeated K/V): the
    plain path of the CPU."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, sq, hkv, g, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    scores = softcap(scores * scale, logit_cap)
    scores = torch.where(mask[:, None, None, :, :], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, hq, d)


def blockwise_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,
    q_pos: torch.Tensor,  # (B, Sq)
    kv_valid: Optional[torch.Tensor],
    window: int,
    logit_cap: float,
    scale: Optional[float] = None,
    kv_block: int = _KV_BLOCK,
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Flash-style exact attention, causal unless ``causal=False``: a loop
    over KV blocks with an online softmax, never materialising (Sq, Skv);
    the plain path for long inputs."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    rep = hq // hkv
    kv_valid = kv_valid if kv_valid is not None else torch.full(
        (b,), skv, dtype=torch.int32, device=q.device)
    qf = q.float()
    acc = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, hq, sq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hq, sq), dtype=torch.float32, device=q.device)
    for j0 in range(0, skv, kv_block):
        # the reference pads the last block with zeros, which the mask hides
        n = min(kv_block, skv - j0)
        kblk = F.pad(k[:, j0 : j0 + n], (0, 0, 0, 0, 0, kv_block - n))
        vblk = F.pad(v[:, j0 : j0 + n], (0, 0, 0, 0, 0, kv_block - n))
        kblk = kblk.repeat_interleave(rep, dim=2).float()
        vblk = vblk.repeat_interleave(rep, dim=2)
        kv_pos = j0 + torch.arange(kv_block, device=q.device)
        scores = softcap(torch.einsum("bqhd,bkhd->bhqk", qf, kblk) * scale, logit_cap)
        msk = kv_pos[None, None, :] < kv_valid[:, None, None]
        if causal:
            msk = msk & (kv_pos[None, None, :] <= q_pos[:, :, None])
        if window:
            msk = msk & (kv_pos[None, None, :] > q_pos[:, :, None] - window)
        scores = torch.where(msk[:, None], scores, _NEG_INF)
        m_new = torch.maximum(m, scores.amax(-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(v.dtype).float(), vblk.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)  # (B, Sq, Hq, D)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    kv_valid: Optional[torch.Tensor] = None,
    *,
    window: int = 0,
    causal: bool = True,
    logit_cap: float = 0.0,
    scale: Optional[float] = None,
    q_seg: Optional[torch.Tensor] = None,
    kv_seg: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """GQA attention, optionally windowed, causal unless ``causal=False``,
    optionally over packed segments: the CUDA kernels on the card, the plain
    paths or the kernels' plain versions on the CPU (see the module
    docstring)."""
    if impl not in ("auto", "naive", "pallas", "blockwise"):
        raise NotImplementedError(f"attention impl {impl!r} is not ported yet")
    if is_dtensor(q) or is_dtensor(k):
        return _attention_on_mesh(
            q, k, v, q_pos, kv_valid, q_seg, kv_seg,
            dict(window=window, causal=causal, logit_cap=logit_cap, scale=scale, impl=impl))
    b, sq = q.shape[0], q.shape[1]
    skv = k.shape[1]
    if window and skv <= window:
        window = 0  # cannot bind
    kernel = (
        not window and impl != "blockwise" and q_seg is None
        and (causal or sq == 1) and (q.is_cuda or impl == "pallas")
    )
    if kernel:
        kv_len = (
            kv_valid if kv_valid is not None
            else torch.full((b,), skv, dtype=torch.int32, device=q.device)
        ).to(torch.int32).contiguous()
        if sq == 1:
            out = decode_attention(
                q[:, 0].contiguous(), k, v, kv_len, scale=scale, logit_cap=logit_cap
            )
            return out[:, None]
        return prefill_attention(
            q.contiguous(), k, v, q_pos.to(torch.int32).contiguous(), kv_len,
            scale=scale, logit_cap=logit_cap,
        )
    if impl == "blockwise" or (
        impl in ("auto", "pallas") and q_seg is None and sq * skv > _NAIVE_ATTN_LIMIT
    ):
        return blockwise_attention(q, k, v, q_pos, kv_valid, window, logit_cap, scale,
                                   causal=causal)
    mask = attention_mask(q_pos, skv, kv_valid, window, causal, q_seg, kv_seg)
    return naive_attention(q, k, v, mask, logit_cap, scale)


def _attention_on_mesh(q, k, v, q_pos, kv_valid, q_seg, kv_seg, kw: dict):
    """`attention` on DTensors: each rank attends over its own batch rows
    and query heads through ``local_map``, taking the kernels or the plain
    paths by the same rule on its local tensors. The batch stays split on
    the mesh dims that split it; the heads on the mesh dim that splits the
    queries' heads (or the keys'), K/V beside them where their heads divide
    over it, else replicated, each rank taking the KV heads its queries read
    (GQA: 8 KV heads on a 16-wide model axis), and their gradient summed
    over that mesh dim. Under an op count (meta tensors) the call is counted
    once at its global shapes (`dist.dtensor.kernel_map`)."""
    b, hq, hkv = q.shape[0], q.shape[2], k.shape[2]
    mesh, batch_dims, head_dim = batch_and_head_dims((q, 0, 2), (k, 0, 2), (v, 0, 2))
    lay = Layout(mesh, b, batch_dims, head_dim, hq, hkv)
    kv_head = None if lay.kv_whole else 2
    qp, kvp = lay.of(0, 2), lay.of(0, kv_head)
    rows = lay.of(0)
    ops = [to_placements(q, mesh, qp), to_placements(k, mesh, kvp), to_placements(v, mesh, kvp),
           to_placements(q_pos, mesh, rows), to_placements(kv_valid, mesh, rows),
           to_placements(q_seg, mesh, rows), to_placements(kv_seg, mesh, rows)]
    kv_slice = lay.kv_slice()

    def counted(q, k, v, q_pos, kv_valid, q_seg, kv_seg):
        return attention(q, k, v, q_pos, kv_valid, q_seg=q_seg, kv_seg=kv_seg, **kw)

    def local(q, k, v, *rest):
        if kv_slice is not None:
            lo, hi = kv_slice
            k, v = k[:, :, lo:hi].contiguous(), v[:, :, lo:hi].contiguous()
        return counted(q, k, v, *rest)

    kv_grad = lay.grad_of(0, kv_head, partial_head=lay.kv_whole)
    return kernel_map(local, counted, mesh, ops, [qp, kv_grad, kv_grad, None, None, None, None],
                      [(tuple(q.shape), q.dtype, qp)])


# ----------------------------------------------------------------------------
# MLP
# ----------------------------------------------------------------------------

def act_fn(name: str):
    return {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def gated_mlp(
    x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor, act: str
) -> torch.Tensor:
    g = act_fn(act)(x @ w_gate)
    u = x @ w_up
    return (g * u) @ w_down


# ----------------------------------------------------------------------------
# Initializers (the JAX package's distributions, drawn from a torch.Generator)
# ----------------------------------------------------------------------------

def dense_init(
    gen: torch.Generator, shape, dtype: torch.dtype, device: torch.device, in_axis: int = 0
) -> torch.Tensor:
    std = 1.0 / math.sqrt(shape[in_axis])
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * std).to(dtype)


def embed_init(
    gen: torch.Generator, shape, dtype: torch.dtype, device: torch.device
) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * 0.02).to(dtype)
