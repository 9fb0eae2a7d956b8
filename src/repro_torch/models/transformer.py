"""Decoder trunk in PyTorch: dense, moe, vlm, ssm and hybrid families (port
of ``repro.models.transformer``).

Four entry points (shape-polymorphic over batch):
  forward_train(params, inputs, cfg, remat)               -> logits (B, S, V)
  prefill_step(params, inputs, cfg, valid_len)            -> (last_logits (B,V), kv)
  chunk_prefill_step(params, tokens, start, valid, cfg, cache) -> (last_logits, cache)
  decode_step(params, tokens, positions, cfg, cache)      -> (logits (B,V), cache)

Parameters are the JAX pytree as a dict of tensors: per-layer weights are
stacked on a leading layer axis ``(L, ...)`` (hybrid: ``(ns, per, ...)``
Mamba2 layers plus one ``shared_attn`` dense layer) and the trunk is a
Python loop over it (``jax.lax.scan`` in the reference). Caches are
``{"k", "v"}`` of shape ``(L, B, max_len, Hkv, Dh)`` for the attention
families (dense, moe, vlm), ``{"conv", "state"}`` stacked ``(L, ...)`` for
ssm, and all four for hybrid (``conv``/``state`` stacked ``(ns, per,
...)``, ``k``/``v`` ``(ns, ...)``). Alternating local/global models
(gemma2: even layers local, window ``sliding_window``) whose cache is
longer than the window get the reference's ring cache instead: ``k``/``v``
of the L/2 global layers at ``max_len`` rows and ``k_local``/``v_local`` of
the L/2 local layers at ``sliding_window`` rows, slot ``pos mod W``. Unlike
the reference, which returns new arrays, the decode and chunk entry points
write into the cache they are given, in place, and return that same dict.

The moe family swaps each layer's MLP for `moe.moe_ffn`; the vlm family
prefills from ``(B, S, d_model)`` embeddings under ``input_mode=
"embeddings"`` (decode and chunked prefill stay on tokens, as in the
reference). Chunked prefill is for the attention families only, as in the
reference (the SSM prefill carries its state through ``ssm_forward``), and
never into a ring cache (ROADMAP C6). `forward_train` is the training
forward of every family here (logits of every position). The encdec
family has its own entry points (`repro_torch.models.encdec`); ngroups > 1
is outside the ported slices and raises NotImplementedError.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.moe import init_moe_params, moe_ffn
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


ATTN_FAMILIES = ("dense", "moe", "vlm")
_GLOBAL_WINDOW = 1 << 30  # the reference's "no window" of gemma2's global layers


def check_supported(cfg: ModelConfig) -> None:
    """Raise for configurations the port does not serve yet."""
    if cfg.family not in (*ATTN_FAMILIES, "ssm", "hybrid", "encdec"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense, moe, vlm, ssm, hybrid and encdec)"
        )
    if cfg.family in ("ssm", "hybrid") and cfg.ssm_ngroups != 1:
        raise NotImplementedError(f"{cfg.name}: ssm_ngroups={cfg.ssm_ngroups} is not ported "
                                  "(the SSD kernel shares one B/C group across heads)")
    if cfg.family == "hybrid" and cfg.num_layers % cfg.hybrid_period:
        raise ValueError(f"{cfg.name}: hybrid depth {cfg.num_layers} is not a multiple of "
                         f"the period {cfg.hybrid_period}")


def _check_decoder(cfg: ModelConfig) -> None:
    """`check_supported`, and refuse the encoder-decoder family, whose entry
    points are in `repro_torch.models.encdec`."""
    check_supported(cfg)
    if cfg.is_encdec:
        raise ValueError(f"{cfg.name} is an encoder-decoder model: use repro_torch.models.encdec "
                         "(or Model), not the decoder trunk")


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


def _init_attn(gen, cfg: ModelConfig, n: int, dtype, dev) -> Dict:
    """(n, ...) attention weights: wq, wk, wv, wo (and the qk-norm weights)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    attn = dict(
        wq=_stacked(gen, n, (d, hq * hd), dtype, dev),
        wk=_stacked(gen, n, (d, hkv * hd), dtype, dev),
        wv=_stacked(gen, n, (d, hkv * hd), dtype, dev),
        wo=_stacked(gen, n, (hq * hd, d), dtype, dev),
    )
    if cfg.use_qk_norm:
        attn["q_norm"] = torch.zeros((n, hd), dtype=dtype, device=dev)
        attn["k_norm"] = torch.zeros((n, hd), dtype=dtype, device=dev)
    return attn


def _init_mlp(gen, cfg: ModelConfig, n: int, dtype, dev) -> Dict:
    """(n, ...) gated-MLP weights."""
    d, f = cfg.d_model, cfg.d_ff
    return dict(
        w_gate=_stacked(gen, n, (d, f), dtype, dev),
        w_up=_stacked(gen, n, (d, f), dtype, dev),
        w_down=_stacked(gen, n, (f, d), dtype, dev),
    )


def _attn_layers(gen, cfg: ModelConfig, n: int, dtype, dev) -> Dict:
    d = cfg.d_model
    return dict(
        attn=_init_attn(gen, cfg, n, dtype, dev),
        pre_attn_norm=torch.zeros((n, d), dtype=dtype, device=dev),
        pre_mlp_norm=torch.zeros((n, d), dtype=dtype, device=dev),
    )


def _dense_layers(gen, cfg: ModelConfig, n: int, dtype, dev) -> Dict:
    return dict(**_attn_layers(gen, cfg, n, dtype, dev), mlp=_init_mlp(gen, cfg, n, dtype, dev))


def _moe_layers(gen, cfg: ModelConfig, n: int, dtype, dev) -> Dict:
    """(n, ...) attention + MoE layers, the experts drawn one layer at a time."""
    first = init_moe_params(gen, cfg, dtype, dev)
    moe = {k: torch.empty((n, *v.shape), dtype=v.dtype, device=dev) for k, v in first.items()}
    for i in range(n):
        layer = first if i == 0 else init_moe_params(gen, cfg, dtype, dev)
        for k, v in layer.items():
            moe[k][i] = v
        del layer
    return dict(**_attn_layers(gen, cfg, n, dtype, dev), moe=moe)


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
    _check_decoder(cfg)
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
    if cfg.family in ("dense", "vlm"):
        params["layers"] = _dense_layers(gen, cfg, cfg.num_layers, dtype, dev)
    elif cfg.family == "moe":
        params["layers"] = _moe_layers(gen, cfg, cfg.num_layers, dtype, dev)
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
    window: int = 0,
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
            window=window, logit_cap=cfg.attn_logit_softcap, impl=cfg.attn_impl,
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
            window=window, logit_cap=cfg.attn_logit_softcap, impl=cfg.attn_impl,
        )
        new_kv = (ck, cv)
    out = out.reshape(b, s, cfg.num_heads * cfg.resolved_head_dim)
    return out @ p["wo"], new_kv


def _ffn(layer: Dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    hn = rms_norm(h, layer["pre_mlp_norm"], cfg.norm_eps)
    if "moe" in layer:  # the moe family's layers (the hybrid's shared block has an mlp)
        return moe_ffn(hn, layer["moe"], cfg)
    m = layer["mlp"]
    return gated_mlp(hn, m["w_gate"], m["w_up"], m["w_down"], cfg.act)


def _layer_window(cfg: ModelConfig, i: int) -> int:
    """Layer i's window (0 = none). Alternating local/global (gemma2): the
    even layers are local, the odd ones take the reference's global
    sentinel, which `attention` drops as a window that cannot bind."""
    if cfg.alternate_local_global and i % 2:
        return _GLOBAL_WINDOW
    return cfg.sliding_window


def _embed_inputs(params: Dict, inputs: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.input_mode == "embeddings":
        return inputs.to(dtype_of(cfg.dtype))
    return params["embed"][inputs]


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

def _unbind(t: torch.Tensor, axes: int):
    """``t`` unbound along its first ``axes`` axes: nested lists of views."""
    if axes == 1:
        return list(t.unbind(0))
    return [_unbind(r, axes - 1) for r in t.unbind(0)]


def _remat(fn, remat: bool):
    """``fn`` recomputed in the backward instead of keeping its activations
    (the reference's ``jax.checkpoint`` of a scanned layer), or as it is."""
    if not remat:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def forward_train(
    params: Dict, inputs: torch.Tensor, cfg: ModelConfig, remat: bool = True
) -> torch.Tensor:
    """Full causal forward from tokens ``(B, S)`` (or embeddings ``(B, S,
    d_model)`` under ``input_mode="embeddings"``); returns logits (B, S, V)
    f32. The trunk is the reference's ``_trunk_nocache`` without a valid
    length: every layer of the attention families and of ssm, or every
    super-block of hybrid (its Mamba2 layers and the shared block), under
    ``remat`` recomputed in the backward (`torch.utils.checkpoint`, where
    the reference wraps the scanned body in ``jax.checkpoint``). On the
    card the causal attention takes the prefill kernel and its backward,
    and the SSD scan of ssm and hybrid layers its forward (writing the
    state at every chunk start) and its backward kernels, through
    ``SSDScanFn``; under remat each forward kernel runs twice."""
    _check_decoder(cfg)
    # tokens through F.embedding rather than indexing: its backward on the card
    # sums each row's gradients without atomics, so a resumed run is bit-identical
    x = (_embed_inputs(params, inputs, cfg) if cfg.input_mode == "embeddings"
         else torch.nn.functional.embedding(inputs, params["embed"]))
    b, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    # each stacked weight unbound once: in the backward one stack per weight
    # gathers the layers' gradients, where indexing it per layer would scatter
    # each layer's gradient into a zero tensor the size of the whole stack
    layers = _map(lambda t: _unbind(t, 2 if cfg.family == "hybrid" else 1), params["layers"])
    if cfg.family in ATTN_FAMILIES:
        for i in range(cfg.num_layers):
            layer, win = layer_params(layers, i), _layer_window(cfg, i)

            def body(h, layer=layer, win=win):
                return _layer_step(layer, h, positions, cfg, window=win)[0]

            x = _remat(body, remat)(x)
    elif cfg.family == "ssm":
        for i in range(cfg.num_layers):
            layer = layer_params(layers, i)
            x = _remat(lambda h, layer=layer: _ssm_layer(layer, h, cfg, None)[0], remat)(x)
    else:  # hybrid
        ns, per = hybrid_blocks(cfg)
        for i in range(ns):
            block = [_map(lambda t, i=i, j=j: t[i][j], layers) for j in range(per)]

            def super_body(h, block=block):
                for layer in block:
                    h = _ssm_layer(layer, h, cfg, None)[0]
                return _layer_step(params["shared_attn"], h, positions, cfg)[0]

            x = _remat(super_body, remat)(x)
    return logits_from_hidden(params, x, cfg)


def prefill_step(
    params: Dict,
    inputs: torch.Tensor,  # (B, S) tokens or (B, S, d_model) embeddings
    cfg: ModelConfig,
    valid_len: Optional[torch.Tensor] = None,
):
    """One-shot prefill from tokens ``(B, S)`` (or embeddings ``(B, S,
    d_model)`` under ``input_mode="embeddings"``): returns (last-token
    logits (B, V), kv), the tree a disaggregated deployment ships to the
    decode instance, as the reference's:
      attention families: (k, v) stacked ``(L, B, S, Hkv, Dh)``
      ssm:    dict(conv (L, B, W-1, Cch), state (L, B, H, P, N))
      hybrid: (dict(conv, state) stacked ``(ns, per, ...)``,
               (k, v) stacked ``(ns, B, S, Hkv, Dh)``)"""
    _check_decoder(cfg)
    x = _embed_inputs(params, inputs, cfg)
    b, s = x.shape[0], x.shape[1]
    dev = x.device
    positions = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
    if valid_len is None:
        valid_len = torch.full((b,), s, dtype=torch.int32, device=dev)
    valid_len = valid_len.to(device=dev, dtype=torch.int32)
    layers = params["layers"]
    if cfg.family in ATTN_FAMILIES:
        ks, vs = [], []
        for i in range(cfg.num_layers):
            x, (k, v) = _layer_step(
                layer_params(layers, i), x, positions, cfg,
                window=_layer_window(cfg, i), kv_valid=valid_len,
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
    _check_decoder(cfg)
    x = params["embed"][tokens]
    positions = positions.to(device=x.device, dtype=torch.int32)
    pos2 = positions[:, None]
    kv_valid = positions + 1
    layers = params["layers"]
    if "k_local" in cache:
        x = _decode_windowed(params, x, positions, cfg, cache)
    elif cfg.family in ATTN_FAMILIES:
        for i in range(cfg.num_layers):
            x, _ = _layer_step(
                layer_params(layers, i), x, pos2, cfg, window=_layer_window(cfg, i),
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
    to keep the step free of device syncs). Attention families only, as in
    the reference, and never into a ring cache: the reference's chunk
    pairs its L layers with the ring's L/2 rows and fails (ROADMAP C6)."""
    _check_decoder(cfg)
    if cfg.family not in ATTN_FAMILIES:
        raise NotImplementedError(f"chunked prefill is for attention families; {cfg.name} is "
                                  f"{cfg.family!r} (use prefill_step)")
    if "k_local" in cache:
        raise ValueError(f"{cfg.name}: chunked prefill into a ring cache (k_local/v_local of "
                         f"{cfg.sliding_window} rows) is not supported; keep max_len <= "
                         "sliding_window (ROADMAP C6)")
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
            window=_layer_window(cfg, i),
            kv_cache=(cache["k"][i], cache["v"][i]), kv_valid=kv_valid, starts=starts,
        )
    last_idx = torch.tensor([max(n - 1, 0) for n in valids], device=dev)
    last = x[torch.arange(b, device=dev), last_idx]
    return logits_from_hidden(params, last, cfg), cache


# ----------------------------------------------------------------------------
# Ring cache of the local layers (alternating local/global)
# ----------------------------------------------------------------------------

def _decode_windowed(params: Dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
                     cache: Dict) -> torch.Tensor:
    """The layers of a decode step over a ring cache, as (local, global)
    pairs. The ring keeps the last W = sliding_window positions: slot j
    holds absolute position a_j = pos - ((pos - j) mod W), which the
    reference masks with a_j >= 0. That is exactly slot j < min(pos + 1, W),
    and RoPE is applied before the write while the softmax does not depend
    on the order of the rows, so the local layer is plain causal attention
    over the ring with kv_valid = min(pos + 1, W): the decode kernel on the
    card. Returns the hidden state; the cache is written in place."""
    b = x.shape[0]
    w = cfg.sliding_window
    pos2 = positions[:, None]
    kv_valid = positions + 1
    ring_valid = torch.clamp(kv_valid, max=w)
    rows = torch.arange(b, device=x.device)
    slot = positions.long() % w
    layers = params["layers"]
    for i in range(cfg.num_layers // 2):
        loc, glo = layer_params(layers, 2 * i), layer_params(layers, 2 * i + 1)
        # local layer: the ring
        q, k, v = _attn_qkv(loc["attn"], rms_norm(x, loc["pre_attn_norm"], cfg.norm_eps),
                            pos2, cfg)
        ck, cv = cache["k_local"][i], cache["v_local"][i]
        ck[rows, slot] = k[:, 0]
        cv[rows, slot] = v[:, 0]
        a = attention(q, ck, cv, pos2, ring_valid, logit_cap=cfg.attn_logit_softcap,
                      impl=cfg.attn_impl)
        x = x + a.reshape(b, 1, -1) @ loc["attn"]["wo"]
        x = x + _ffn(loc, x, cfg)
        # global layer: the full cache
        x, _ = _layer_step(glo, x, pos2, cfg, kv_cache=(cache["k"][i], cache["v"][i]),
                           kv_valid=kv_valid)
    return x


def _use_windowed_cache(cfg: ModelConfig, max_len: int) -> bool:
    return (
        cfg.alternate_local_global
        and cfg.sliding_window > 0
        and max_len > cfg.sliding_window
        and cfg.num_layers % 2 == 0
    )


def _handoff_ring(k: torch.Tensor, v: torch.Tensor, cache: Dict, valid_len) -> None:
    """Prefill K/V ``(L, B, S, Hkv, Dh)`` into a ring cache: the odd
    (global) layers into the first S rows of ``k``/``v``; for the even
    (local) layers, slot j of row b takes the largest position a <
    valid_len[b] with a mod W = j, and a slot no such position reaches is
    left as it is (decode masks it until it writes there)."""
    s, b = k.shape[2], k.shape[1]
    w = cache["k_local"].shape[2]
    cache["k"][:, :, :s].copy_(k[1::2])
    cache["v"][:, :, :s].copy_(v[1::2])
    dev = k.device
    last = (torch.as_tensor(valid_len if valid_len is not None else [s] * b)
            .to(device=dev, dtype=torch.long) - 1)
    j = torch.arange(w, device=dev)
    a = last[:, None] - torch.remainder(last[:, None] - j[None, :], w)  # (B, W)
    ok = (a >= 0)[None, :, :, None, None]
    rows = torch.arange(b, device=dev)[:, None]
    src = a.clamp(min=0)
    for name, kv in (("k_local", k), ("v_local", v)):
        ring = cache[name]
        ring.copy_(torch.where(ok, kv[0::2][:, rows, src], ring))


# ----------------------------------------------------------------------------
# Cache structure
# ----------------------------------------------------------------------------

def handoff(cfg: ModelConfig, kv, cache: Dict, valid_len=None) -> Dict:
    """Write the tree `prefill_step` returned into a decode cache, in place:
    the recurrent ``conv``/``state`` leaves whole, K/V into the first S
    positions, or into a ring cache by position (`_handoff_ring`; there
    ``valid_len``, the prompts' lengths as `prefill_step` took them, says
    which positions are real, all S when None). Returns ``cache``."""
    if cfg.family == "ssm":
        rec, attn = kv, None
    elif cfg.family == "hybrid":
        rec, attn = kv
    else:
        rec, attn = None, kv
    if rec is not None:
        cache["conv"].copy_(rec["conv"])
        cache["state"].copy_(rec["state"])
    if attn is not None and "k_local" in cache:
        _handoff_ring(*attn, cache, valid_len)
    elif attn is not None:
        k, v = attn
        s = k.shape[2]
        cache["k"][:, :, :s].copy_(k)
        cache["v"][:, :, :s].copy_(v)
    return cache


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> Dict:
    """{leaf: (shape, dtype-name)} of the decode cache: plain k/v, the ring
    cache of alternating local/global models longer than their window, the
    stacked recurrent cache, or both for hybrid. The conv leaf has the
    model's dtype (ROADMAP C3)."""
    _check_decoder(cfg)
    hd = cfg.resolved_head_dim
    if cfg.family in ATTN_FAMILIES and _use_windowed_cache(cfg, max_len):
        half = cfg.num_layers // 2
        kv_g = (half, batch, max_len, cfg.num_kv_heads, hd)
        kv_l = (half, batch, cfg.sliding_window, cfg.num_kv_heads, hd)
        return dict(k=(kv_g, cfg.dtype), v=(kv_g, cfg.dtype),
                    k_local=(kv_l, cfg.dtype), v_local=(kv_l, cfg.dtype))
    if cfg.family in ATTN_FAMILIES:
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
