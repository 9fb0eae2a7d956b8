"""Dense decoder trunk in PyTorch (port of ``repro.models.transformer``,
dense family only).

Three entry points (shape-polymorphic over batch):
  prefill_step(params, inputs, cfg, valid_len)            -> (last_logits (B,V), kv)
  chunk_prefill_step(params, tokens, start, valid, cfg, cache) -> (last_logits, cache)
  decode_step(params, tokens, positions, cfg, cache)      -> (logits (B,V), cache)

Parameters are the JAX pytree as a dict of tensors: per-layer weights are
stacked on a leading layer axis ``(L, ...)`` and the trunk is a Python loop
over it (``jax.lax.scan`` in the reference). Caches are ``{"k", "v"}`` of
shape ``(L, B, max_len, Hkv, Dh)``. Unlike the reference, which returns
new arrays, the cache entry points write into the cache they are given, in
place, and return that same dict.

The moe, ssm, hybrid, encdec and vlm families, sliding windows and
alternating local/global layers are outside this slice and raise
NotImplementedError.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import (
    attention,
    dense_init,
    dtype_of,
    embed_init,
    gated_mlp,
    rms_norm,
    rope,
    softcap,
)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for configurations this slice of the port does not serve."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet (dense only)")
    if cfg.sliding_window or cfg.alternate_local_global:
        raise NotImplementedError(f"{cfg.name}: sliding-window attention is not ported yet")
    if cfg.input_mode != "tokens":
        raise NotImplementedError(f"{cfg.name}: input_mode {cfg.input_mode!r} is not ported yet")


# ----------------------------------------------------------------------------
# Param init
# ----------------------------------------------------------------------------

def _stacked(gen, n: int, shape, dtype, device) -> torch.Tensor:
    """(n, *shape) dense-initialized weights, drawn one layer at a time so the
    f32 draw never holds more than one layer."""
    out = torch.empty((n, *shape), dtype=dtype, device=device)
    for i in range(n):
        out[i] = dense_init(gen, shape, dtype, device)
    return out


def init_params(cfg: ModelConfig, seed: int = 0, device: DeviceLike = "cuda") -> Dict:
    """Random weights with the JAX initializers' distributions, drawn from a
    `torch.Generator` seeded with ``seed`` on ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, hd, n = cfg.d_model, cfg.resolved_head_dim, cfg.num_layers
    hq, hkv, f = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    params: Dict = dict(
        embed=embed_init(gen, (cfg.vocab_size, d), dtype, dev),
        final_norm=torch.zeros((d,), dtype=dtype, device=dev),
    )
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, cfg.vocab_size), dtype, dev)
    attn = dict(
        wq=_stacked(gen, n, (d, hq * hd), dtype, dev),
        wk=_stacked(gen, n, (d, hkv * hd), dtype, dev),
        wv=_stacked(gen, n, (d, hkv * hd), dtype, dev),
        wo=_stacked(gen, n, (hq * hd, d), dtype, dev),
    )
    if cfg.use_qk_norm:
        attn["q_norm"] = torch.zeros((n, hd), dtype=dtype, device=dev)
        attn["k_norm"] = torch.zeros((n, hd), dtype=dtype, device=dev)
    params["layers"] = dict(
        attn=attn,
        mlp=dict(
            w_gate=_stacked(gen, n, (d, f), dtype, dev),
            w_up=_stacked(gen, n, (d, f), dtype, dev),
            w_down=_stacked(gen, n, (f, d), dtype, dev),
        ),
        pre_attn_norm=torch.zeros((n, d), dtype=dtype, device=dev),
        pre_mlp_norm=torch.zeros((n, d), dtype=dtype, device=dev),
    )
    return params


def layer_params(layers: Dict, i: int) -> Dict:
    """Layer ``i``'s weights: views into the stacked ``(L, ...)`` tensors."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in layers.items()}


# ----------------------------------------------------------------------------
# Blocks
# ----------------------------------------------------------------------------

def _attn_qkv(p: Dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(b, s, cfg.num_heads, hd)
    k = (x @ p["wk"]).reshape(b, s, cfg.num_kv_heads, hd)
    v = (x @ p["wv"]).reshape(b, s, cfg.num_kv_heads, hd)
    if cfg.use_qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_block(
    p: Dict,
    x: torch.Tensor,
    positions: torch.Tensor,  # (B, S)
    cfg: ModelConfig,
    *,
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (B,M,Hkv,Dh) x2
    kv_valid: Optional[torch.Tensor] = None,  # (B,)
    starts: Optional[Sequence[int]] = None,  # host copy of positions[:, 0], S > 1
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Attention sublayer. Returns (out, (k, v)).

    Without kv_cache: self-attention within the chunk; returns chunk K/V.
    With kv_cache: write this chunk's K/V into the cache at `positions`, in
    place, attend against the whole cache; returns the cache K/V.
    """
    b, s, _ = x.shape
    q, k, v = _attn_qkv(p, x, positions, cfg)
    if kv_cache is None:
        out = attention(
            q, k, v, positions, kv_valid,
            logit_cap=cfg.attn_logit_softcap, impl=cfg.attn_impl,
        )
        new_kv = (k, v)
    else:
        ck, cv = kv_cache
        if s == 1:
            # an indexed write at each row's position; the reference writes
            # with a one-hot select over the whole cache because SPMD
            # partitions a select but not a per-batch scatter, which one
            # card does not need
            rows = torch.arange(b, device=x.device)
            pos = positions[:, 0]
            ck[rows, pos] = k[:, 0]
            cv[rows, pos] = v[:, 0]
        else:
            # each chunk at its true positions: rows past the cache end
            # (padding of the last chunk) are dropped, never shifted back
            # as the reference's clamped dynamic_update_slice does
            m = ck.shape[1]
            for i, st in enumerate(starts):
                n = min(s, m - st)
                if n > 0:
                    ck[i, st : st + n] = k[i, :n]
                    cv[i, st : st + n] = v[i, :n]
        out = attention(
            q, ck, cv, positions, kv_valid,
            logit_cap=cfg.attn_logit_softcap, impl=cfg.attn_impl,
        )
        new_kv = (ck, cv)
    out = out.reshape(b, s, cfg.num_heads * cfg.resolved_head_dim)
    return out @ p["wo"], new_kv


def _ffn(layer: Dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    hn = rms_norm(h, layer["pre_mlp_norm"], cfg.norm_eps)
    m = layer["mlp"]
    return gated_mlp(hn, m["w_gate"], m["w_up"], m["w_down"], cfg.act)


def logits_from_hidden(params: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["lm_head"]
    return softcap(logits.float(), cfg.final_logit_softcap)


def _layer_step(layer: Dict, h: torch.Tensor, positions, cfg: ModelConfig, **attn_kw):
    a_out, kv = attn_block(
        layer["attn"], rms_norm(h, layer["pre_attn_norm"], cfg.norm_eps), positions, cfg,
        **attn_kw,
    )
    h = h + a_out
    return h + _ffn(layer, h, cfg), kv


# ----------------------------------------------------------------------------
# Entry points
# ----------------------------------------------------------------------------

def prefill_step(
    params: Dict,
    inputs: torch.Tensor,  # (B, S) tokens
    cfg: ModelConfig,
    valid_len: Optional[torch.Tensor] = None,
):
    """One-shot prefill: returns (last-token logits (B, V), (k, v)) with k, v
    stacked ``(L, B, S, Hkv, Dh)`` — what a disaggregated deployment ships
    to the decode instance."""
    check_supported(cfg)
    x = params["embed"][inputs]
    b, s = inputs.shape
    dev = x.device
    positions = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
    if valid_len is None:
        valid_len = torch.full((b,), s, dtype=torch.int32, device=dev)
    valid_len = valid_len.to(device=dev, dtype=torch.int32)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, (k, v) = _layer_step(
            layer_params(params["layers"], i), x, positions, cfg, kv_valid=valid_len
        )
        ks.append(k)
        vs.append(v)
    last = x[torch.arange(b, device=dev), valid_len.long() - 1]
    return logits_from_hidden(params, last, cfg), (torch.stack(ks), torch.stack(vs))


def decode_step(
    params: Dict,
    tokens: torch.Tensor,  # (B, 1) int
    positions: torch.Tensor,  # (B,) current write position
    cfg: ModelConfig,
    cache: Dict,
):
    """Single-token decode. Returns (logits (B, V), cache written in place)."""
    check_supported(cfg)
    x = params["embed"][tokens]
    positions = positions.to(device=x.device, dtype=torch.int32)
    pos2 = positions[:, None]
    kv_valid = positions + 1
    for i in range(cfg.num_layers):
        x, _ = _layer_step(
            layer_params(params["layers"], i), x, pos2, cfg,
            kv_cache=(cache["k"][i], cache["v"][i]), kv_valid=kv_valid,
        )
    return logits_from_hidden(params, x[:, 0], cfg), cache


def chunk_prefill_step(
    params: Dict,
    tokens: torch.Tensor,  # (B, C), one chunk per request, right-padded
    start,  # (B,) context offset (tokens already prefilled): tensor or ints
    valid,  # (B,) valid tokens in this chunk (<= C): tensor or ints
    cfg: ModelConfig,
    cache: Dict,
):
    """Chunked prefill (Sarathi-style): writes this chunk's KV into the cache
    at its true positions ``start ..`` and attends to cache[0 : start+valid].
    Returns (last-valid-token logits (B, V), cache written in place). The
    valid tokens must fit the cache: ``start + valid <= max_len``.

    ``start`` and ``valid`` are read on the host (pass CPU tensors or ints
    to keep the step free of device syncs)."""
    check_supported(cfg)
    x = params["embed"][tokens]
    b, c = tokens.shape
    dev = x.device
    starts = [int(s) for s in torch.as_tensor(start).reshape(-1).tolist()]
    valids = [int(s) for s in torch.as_tensor(valid).reshape(-1).tolist()]
    m = cache["k"].shape[2]
    for st, n in zip(starts, valids, strict=True):
        if st < 0 or st + n > m:
            raise ValueError(f"chunk [{st}, {st + n}) does not fit a cache of {m} positions")
    start_d = torch.tensor(starts, dtype=torch.int32, device=dev)
    positions = start_d[:, None] + torch.arange(c, dtype=torch.int32, device=dev)[None, :]
    kv_valid = start_d + torch.tensor(valids, dtype=torch.int32, device=dev)
    for i in range(cfg.num_layers):
        x, _ = _layer_step(
            layer_params(params["layers"], i), x, positions, cfg,
            kv_cache=(cache["k"][i], cache["v"][i]), kv_valid=kv_valid, starts=starts,
        )
    last_idx = torch.tensor([max(n - 1, 0) for n in valids], device=dev)
    last = x[torch.arange(b, device=dev), last_idx]
    return logits_from_hidden(params, last, cfg), cache


# ----------------------------------------------------------------------------
# Cache structure
# ----------------------------------------------------------------------------

def cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> Dict:
    """{leaf: (shape, dtype-name)} of the decode cache (plain k/v)."""
    check_supported(cfg)
    kv = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return dict(k=(kv, cfg.dtype), v=(kv, cfg.dtype))
