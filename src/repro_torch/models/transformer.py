"""Decoder trunk in PyTorch: dense, ssm and hybrid families (port of
``repro.models.transformer``).

Three entry points (shape-polymorphic over batch):
  prefill_step(params, inputs, cfg, valid_len)            -> (last_logits (B,V), kv)
  chunk_prefill_step(params, tokens, start, valid, cfg, cache) -> (last_logits, cache)
  decode_step(params, tokens, positions, cfg, cache)      -> (logits (B,V), cache)

Parameters are the JAX pytree as a dict of tensors: per-layer weights are
stacked on a leading layer axis ``(L, ...)`` (hybrid: ``(ns, per, ...)``
Mamba2 layers plus one ``shared_attn`` dense layer) and the trunk is a
Python loop over it (``jax.lax.scan`` in the reference). Caches are
``{"k", "v"}`` of shape ``(L, B, max_len, Hkv, Dh)`` for the dense family,
``{"conv", "state"}`` stacked ``(L, ...)`` for ssm, and all four for
hybrid (``conv``/``state`` stacked ``(ns, per, ...)``, ``k``/``v``
``(ns, ...)``). Unlike the reference, which returns new arrays, the decode
and chunk entry points write into the cache they are given, in place, and
return that same dict.

Chunked prefill is for the dense family only, as in the reference (the SSM
prefill carries its state through ``ssm_forward``). The moe, encdec and vlm
families, sliding windows, alternating local/global layers and ngroups > 1
are outside the ported slices and raise NotImplementedError.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import ssm as ssm_mod
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
    """Raise for configurations the port does not serve yet."""
    if cfg.family not in ("dense", "ssm", "hybrid"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense, ssm and hybrid only)"
        )
    if cfg.family in ("ssm", "hybrid") and cfg.ssm_ngroups != 1:
        raise NotImplementedError(f"{cfg.name}: ssm_ngroups={cfg.ssm_ngroups} is not ported "
                                  "(the SSD kernel shares one B/C group across heads)")
    if cfg.family == "hybrid" and cfg.num_layers % cfg.hybrid_period:
        raise ValueError(f"{cfg.name}: hybrid depth {cfg.num_layers} is not a multiple of "
                         f"the period {cfg.hybrid_period}")
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


def _dense_layers(gen, cfg: ModelConfig, n: int, dtype, dev) -> Dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv, f = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    attn = dict(
        wq=_stacked(gen, n, (d, hq * hd), dtype, dev),
        wk=_stacked(gen, n, (d, hkv * hd), dtype, dev),
        wv=_stacked(gen, n, (d, hkv * hd), dtype, dev),
        wo=_stacked(gen, n, (hq * hd, d), dtype, dev),
    )
    if cfg.use_qk_norm:
        attn["q_norm"] = torch.zeros((n, hd), dtype=dtype, device=dev)
        attn["k_norm"] = torch.zeros((n, hd), dtype=dtype, device=dev)
    return dict(
        attn=attn,
        mlp=dict(
            w_gate=_stacked(gen, n, (d, f), dtype, dev),
            w_up=_stacked(gen, n, (d, f), dtype, dev),
            w_down=_stacked(gen, n, (f, d), dtype, dev),
        ),
        pre_attn_norm=torch.zeros((n, d), dtype=dtype, device=dev),
        pre_mlp_norm=torch.zeros((n, d), dtype=dtype, device=dev),
    )


def _ssm_layers(gen, cfg: ModelConfig, n: int, dtype, dev) -> Dict:
    """(n, ...) Mamba2 layers, drawn one layer at a time."""
    first = ssm_mod.init_ssm_params(gen, cfg, dtype, dev)
    ssm = {k: torch.empty((n, *v.shape), dtype=v.dtype, device=dev) for k, v in first.items()}
    for i in range(n):
        layer = first if i == 0 else ssm_mod.init_ssm_params(gen, cfg, dtype, dev)
        for k, v in layer.items():
            ssm[k][i] = v
    return dict(ssm=ssm, pre_norm=torch.zeros((n, cfg.d_model), dtype=dtype, device=dev))


def hybrid_blocks(cfg: ModelConfig) -> Tuple[int, int]:
    """(super-blocks, Mamba2 layers per super-block)."""
    return cfg.num_layers // cfg.hybrid_period, cfg.hybrid_period


def init_params(cfg: ModelConfig, seed: int = 0, device: DeviceLike = "cuda") -> Dict:
    """Random weights with the JAX initializers' distributions, drawn from a
    `torch.Generator` seeded with ``seed`` on ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model
    params: Dict = dict(
        embed=embed_init(gen, (cfg.vocab_size, d), dtype, dev),
        final_norm=torch.zeros((d,), dtype=dtype, device=dev),
    )
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, cfg.vocab_size), dtype, dev)
    if cfg.family == "dense":
        params["layers"] = _dense_layers(gen, cfg, cfg.num_layers, dtype, dev)
    elif cfg.family == "ssm":
        params["layers"] = _ssm_layers(gen, cfg, cfg.num_layers, dtype, dev)
    else:  # hybrid
        ns, per = hybrid_blocks(cfg)
        inner = _ssm_layers(gen, cfg, ns * per, dtype, dev)
        params["layers"] = _map(lambda t: t.reshape(ns, per, *t.shape[1:]), inner)
        params["shared_attn"] = layer_params(_dense_layers(gen, cfg, 1, dtype, dev), 0)
    return params


def _map(fn, tree: Dict) -> Dict:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def layer_params(layers: Dict, i) -> Dict:
    """Layer ``i``'s weights: views into the stacked ``(L, ...)`` tensors."""
    return _map(lambda t: t[i], layers)


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
    """A dense layer (also the hybrid's shared attention + MLP block)."""
    a_out, kv = attn_block(
        layer["attn"], rms_norm(h, layer["pre_attn_norm"], cfg.norm_eps), positions, cfg,
        **attn_kw,
    )
    h = h + a_out
    return h + _ffn(layer, h, cfg), kv


def _ssm_layer(layer: Dict, h: torch.Tensor, cfg: ModelConfig, valid_len) -> Tuple:
    o, cache = ssm_mod.ssm_forward(
        layer["ssm"], rms_norm(h, layer["pre_norm"], cfg.norm_eps), cfg, valid_len
    )
    return h + o, cache


def _ssm_decode_layer(layer: Dict, h: torch.Tensor, cfg: ModelConfig, conv, state):
    """One Mamba2 layer of a decode step; writes the layer's ``conv`` and
    ``state`` cache entries in place."""
    o, c2 = ssm_mod.ssm_decode_step(
        layer["ssm"], rms_norm(h, layer["pre_norm"], cfg.norm_eps), cfg,
        dict(conv=conv, state=state),
    )
    conv.copy_(c2["conv"])
    state.copy_(c2["state"])
    return h + o


def _stack_caches(caches) -> Dict:
    return {k: torch.stack([c[k] for c in caches]) for k in ("conv", "state")}


# ----------------------------------------------------------------------------
# Entry points
# ----------------------------------------------------------------------------

def prefill_step(
    params: Dict,
    inputs: torch.Tensor,  # (B, S) tokens
    cfg: ModelConfig,
    valid_len: Optional[torch.Tensor] = None,
):
    """One-shot prefill: returns (last-token logits (B, V), kv), the tree a
    disaggregated deployment ships to the decode instance, as the
    reference's:
      dense:  (k, v) stacked ``(L, B, S, Hkv, Dh)``
      ssm:    dict(conv (L, B, W-1, Cch), state (L, B, H, P, N))
      hybrid: (dict(conv, state) stacked ``(ns, per, ...)``,
               (k, v) stacked ``(ns, B, S, Hkv, Dh)``)"""
    check_supported(cfg)
    x = params["embed"][inputs]
    b, s = inputs.shape
    dev = x.device
    positions = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
    if valid_len is None:
        valid_len = torch.full((b,), s, dtype=torch.int32, device=dev)
    valid_len = valid_len.to(device=dev, dtype=torch.int32)
    layers = params["layers"]
    if cfg.family == "dense":
        ks, vs = [], []
        for i in range(cfg.num_layers):
            x, (k, v) = _layer_step(
                layer_params(layers, i), x, positions, cfg, kv_valid=valid_len
            )
            ks.append(k)
            vs.append(v)
        kv = (torch.stack(ks), torch.stack(vs))
    elif cfg.family == "ssm":
        caches = []
        for i in range(cfg.num_layers):
            x, c = _ssm_layer(layer_params(layers, i), x, cfg, valid_len)
            caches.append(c)
        kv = _stack_caches(caches)
    else:  # hybrid
        ns, per = hybrid_blocks(cfg)
        blocks, ks, vs = [], [], []
        for i in range(ns):
            caches = []
            for j in range(per):
                x, c = _ssm_layer(layer_params(layers, (i, j)), x, cfg, valid_len)
                caches.append(c)
            blocks.append(_stack_caches(caches))
            x, (k, v) = _layer_step(params["shared_attn"], x, positions, cfg,
                                    kv_valid=valid_len)
            ks.append(k)
            vs.append(v)
        kv = (_stack_caches(blocks), (torch.stack(ks), torch.stack(vs)))
    last = x[torch.arange(b, device=dev), valid_len.long() - 1]
    return logits_from_hidden(params, last, cfg), kv


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
    layers = params["layers"]
    if cfg.family == "dense":
        for i in range(cfg.num_layers):
            x, _ = _layer_step(
                layer_params(layers, i), x, pos2, cfg,
                kv_cache=(cache["k"][i], cache["v"][i]), kv_valid=kv_valid,
            )
    elif cfg.family == "ssm":
        for i in range(cfg.num_layers):
            x = _ssm_decode_layer(layer_params(layers, i), x, cfg, cache["conv"][i],
                                  cache["state"][i])
    else:  # hybrid
        ns, per = hybrid_blocks(cfg)
        for i in range(ns):
            for j in range(per):
                x = _ssm_decode_layer(layer_params(layers, (i, j)), x, cfg,
                                      cache["conv"][i, j], cache["state"][i, j])
            x, _ = _layer_step(
                params["shared_attn"], x, pos2, cfg,
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
    to keep the step free of device syncs). Dense family only, as in the
    reference."""
    check_supported(cfg)
    if cfg.family != "dense":
        raise NotImplementedError(f"chunked prefill is for attention families; {cfg.name} is "
                                  f"{cfg.family!r} (use prefill_step)")
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

def handoff(cfg: ModelConfig, kv, cache: Dict) -> Dict:
    """Write the tree `prefill_step` returned into a decode cache, in place:
    the recurrent ``conv``/``state`` leaves whole, K/V into the first S
    positions. Returns ``cache``."""
    if cfg.family == "ssm":
        rec, attn = kv, None
    elif cfg.family == "hybrid":
        rec, attn = kv
    else:
        rec, attn = None, kv
    if rec is not None:
        cache["conv"].copy_(rec["conv"])
        cache["state"].copy_(rec["state"])
    if attn is not None:
        k, v = attn
        s = k.shape[2]
        cache["k"][:, :, :s].copy_(k)
        cache["v"][:, :, :s].copy_(v)
    return cache


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> Dict:
    """{leaf: (shape, dtype-name)} of the decode cache: plain k/v, the
    stacked recurrent cache, or both for hybrid. The conv leaf has the
    model's dtype (ROADMAP C3)."""
    check_supported(cfg)
    hd = cfg.resolved_head_dim
    if cfg.family == "dense":
        kv = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, hd)
        return dict(k=(kv, cfg.dtype), v=(kv, cfg.dtype))
    s = ssm_mod.ssm_cache_shape(cfg, batch)
    if cfg.family == "ssm":
        lead = (cfg.num_layers,)
        return {k: ((*lead, *shape), dt) for k, (shape, dt) in s.items()}
    ns, per = hybrid_blocks(cfg)
    kv = (ns, batch, max_len, cfg.num_kv_heads, hd)
    out = {k: ((ns, per, *shape), dt) for k, (shape, dt) in s.items()}
    return dict(**out, k=(kv, cfg.dtype), v=(kv, cfg.dtype))
