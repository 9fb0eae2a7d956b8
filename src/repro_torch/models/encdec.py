"""Encoder-decoder trunk in PyTorch, the seamless-m4t-medium backbone (port of
``repro.models.encdec``).

The modality frontend is a stub, as in the reference: the encoder consumes
precomputed frame embeddings (B, S_src, d_model) and is bidirectional. The
decoder is a causal transformer with cross attention over the encoder's
output; decode caches default to a fixed encoder memory of
`DECODE_ENC_LEN` rows, the reference's decode shape.

Entry points (shape-polymorphic over batch):
  forward_train(params, src, tgt, cfg)                        -> logits (B, S_tgt, V)
  prefill_step(params, src, tgt, cfg, src_valid, tgt_valid) -> (last logits (B, V), kv)
  decode_step(params, tokens, positions, cfg, cache, enc_valid) -> (logits (B, V), cache)
  handoff(cfg, kv, cache_or_max_len)                           -> decode cache

Parameters are the JAX pytree as a dict of tensors: ``enc_layers`` stacked
``(enc_layers, ...)``, ``dec_layers`` stacked ``(num_layers, ...)``, the
two final norms and the embeddings (``lm_head`` unless tied). The trunks
are Python loops over the stacked layers (``jax.lax.scan`` in the
reference). Caches are ``self_k``/``self_v`` ``(L, B, max_len, Hkv, Dh)``
and ``cross_k``/``cross_v`` ``(L, B, S_enc, Hkv, Dh)``. Like the decoder
trunk's, `decode_step` writes the self K/V into the cache it is given, in
place, and returns that same dict.

Attention: every call passes ``impl=cfg.attn_impl``, so on the card the
decoder's causal self attention takes the prefill kernel (in
`prefill_step`) and the decode kernel (in `decode_step`), and the cross
attention of a decode step (one query, non-causal) takes the decode kernel
with ``kv_len = enc_valid`` (the cross leaf's length where it is None).
The encoder and the cross attention of `prefill_step` are non-causal with
many queries: the plain paths, on the card too (`layers.attention`). The
reference passes the default ``impl="auto"`` to every attention call of
this family, so under ``attn_impl="pallas"`` it stays on its plain paths;
the two compute the same function.

The reference's ``Model.decode`` passes no ``enc_valid``, so on a cache
whose cross leaves have more rows than the encoder's output (its
``init_cache`` gives them `DECODE_ENC_LEN`) it attends over the zero rows
past the encoder's length (ROADMAP C7, refused: the cache would have to
carry that length). `handoff` keeps the cross leaves at exactly the
encoder's length, so a decode on its cache attends only real memory.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.act_sharding import constrain_batch
from repro_torch.dist.dtensor import is_dtensor, local_rows, split_heads
from repro_torch.models.layers import (
    attention,
    dense_init,
    dtype_of,
    embed_init,
    gated_mlp,
    rms_norm,
)
from repro_torch.models.transformer import (
    _attn_qkv,
    _last_rows,
    _local_cache,
    _meshed,
    _remat,
    _init_attn,
    embed_tokens,
    _init_mlp,
    check_supported,
    layer_params,
    logits_from_hidden,
)

DECODE_ENC_LEN = 4096  # encoder memory length of the reference's decode shape


def _check(cfg: ModelConfig) -> None:
    check_supported(cfg)
    if not cfg.is_encdec:
        raise ValueError(f"{cfg.name} is not an encoder-decoder model (enc_layers = 0)")


# ----------------------------------------------------------------------------
# Param init
# ----------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, device: DeviceLike = "cuda") -> Dict:
    """Random weights with the JAX initializers' distributions, drawn from a
    `torch.Generator` seeded with ``seed`` on ``device``."""
    _check(cfg)
    dev = resolve_device(device)
    return param_tree(cfg, torch.Generator(device=dev).manual_seed(seed), dev)


def param_tree(cfg: ModelConfig, gen: Optional[torch.Generator], dev: torch.device) -> Dict:
    """The parameter tree on ``dev``, drawn from ``gen``: `init_params`'s
    weights, or on the ``meta`` device (``gen`` None) their shapes and
    dtypes alone (`Model.param_struct`)."""
    _check(cfg)
    dtype = dtype_of(cfg.dtype)
    d = cfg.d_model

    def norms(n, *names):
        return {name: torch.zeros((n, d), dtype=dtype, device=dev) for name in names}

    ne, nd = cfg.enc_layers, cfg.num_layers
    params: Dict = dict(
        embed=embed_init(gen, (cfg.vocab_size, d), dtype, dev),
        enc_layers=dict(
            attn=_init_attn(gen, cfg, ne, dtype, dev),
            mlp=_init_mlp(gen, cfg, ne, dtype, dev),
            **norms(ne, "pre_attn_norm", "pre_mlp_norm"),
        ),
        dec_layers=dict(
            self_attn=_init_attn(gen, cfg, nd, dtype, dev),
            cross_attn=_init_attn(gen, cfg, nd, dtype, dev),
            mlp=_init_mlp(gen, cfg, nd, dtype, dev),
            **norms(nd, "pre_self_norm", "pre_cross_norm", "pre_mlp_norm"),
        ),
        enc_final_norm=torch.zeros((d,), dtype=dtype, device=dev),
        final_norm=torch.zeros((d,), dtype=dtype, device=dev),
    )
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, cfg.vocab_size), dtype, dev)
    return params


# ----------------------------------------------------------------------------
# Trunks
# ----------------------------------------------------------------------------

def _mlp(layer: Dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    m = layer["mlp"]
    return gated_mlp(rms_norm(h, layer["pre_mlp_norm"], cfg.norm_eps),
                     m["w_gate"], m["w_up"], m["w_down"], cfg.act)


def _valid(n: Optional[torch.Tensor], dev: torch.device) -> Optional[torch.Tensor]:
    return None if n is None else torch.as_tensor(n).to(device=dev, dtype=torch.int32)


@_meshed
def encode(
    params: Dict, src: torch.Tensor, cfg: ModelConfig, src_valid: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """src: (B, S, D) frame embeddings (stub frontend). Bidirectional, with
    RoPE on the encoder's own positions; keys at or past ``src_valid`` are
    masked."""
    _check(cfg)
    x = constrain_batch(src.to(dtype_of(cfg.dtype)))
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    src_valid = _valid(src_valid, x.device)
    for i in range(cfg.enc_layers):
        layer = layer_params(params["enc_layers"], i)
        q, k, v = _attn_qkv(layer["attn"], rms_norm(x, layer["pre_attn_norm"], cfg.norm_eps),
                            positions, cfg)
        a = attention(q, k, v, positions, src_valid, causal=False, impl=cfg.attn_impl)
        x = x + a.reshape(b, s, -1) @ layer["attn"]["wo"]
        x = x + _mlp(layer, x, cfg)
    return rms_norm(x, params["enc_final_norm"], cfg.norm_eps)


def _cross_kv(layer: Dict, enc_out: torch.Tensor, cfg: ModelConfig):
    """A decoder layer's cross-attention K/V of the encoder's output: no
    RoPE, no norm."""
    b, s, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k = split_heads(enc_out @ layer["cross_attn"]["wk"], (b, s, cfg.num_kv_heads, hd), 2)
    v = split_heads(enc_out @ layer["cross_attn"]["wv"], (b, s, cfg.num_kv_heads, hd), 2)
    return k, v


def _write_self(ck, cv, k, v, positions: torch.Tensor) -> None:
    """Write each sequence's new self K/V row at its position, in place (on
    a mesh, each rank its own rows); a position at or past the cache's end
    writes nothing, as the reference's select-update does."""
    if is_dtensor(ck):
        positions = local_rows(positions, ck)
    ck, cv, k, v, _ = _local_cache(ck, cv, k, v)
    m = ck.shape[1]
    pos = positions.long()
    hit = (pos < m)[:, None, None]
    rows, at = torch.arange(ck.shape[0], device=ck.device), pos.clamp(max=m - 1)
    ck[rows, at] = torch.where(hit, k[:, 0], ck[rows, at])
    cv[rows, at] = torch.where(hit, v[:, 0], cv[rows, at])


def _dec_layer_apply(
    layer: Dict,
    h: torch.Tensor,
    positions: torch.Tensor,  # (B, S)
    cfg: ModelConfig,
    self_kv,  # None (in-chunk) or (ck, cv) of one layer, (B, M, Hkv, Dh), S == 1
    cross_k: torch.Tensor,  # (B, S_enc, Hkv, Dh)
    cross_v: torch.Tensor,
    enc_valid: Optional[torch.Tensor],
    tgt_valid: Optional[torch.Tensor],
):
    """One decoder layer: causal self attention, cross attention over the
    encoder memory, gated MLP. With ``self_kv`` (a decode step, S == 1) the
    token's K/V is written into the cache at ``positions`` in place first; a
    position at or past the cache's end writes nothing, as the reference's
    select-update does."""
    b, s, _ = h.shape
    hd = cfg.resolved_head_dim
    q, k, v = _attn_qkv(layer["self_attn"], rms_norm(h, layer["pre_self_norm"], cfg.norm_eps),
                        positions, cfg)
    if self_kv is None:
        a = attention(q, k, v, positions, tgt_valid, causal=True, impl=cfg.attn_impl)
        new_self = (k, v)
    else:
        if s != 1:
            raise ValueError(f"a decoder layer over a cache takes one token, got {s}")
        ck, cv = self_kv
        _write_self(ck, cv, k, v, positions[:, 0])
        a = attention(q, ck, cv, positions, tgt_valid, causal=True, impl=cfg.attn_impl)
        new_self = (ck, cv)
    h = h + a.reshape(b, s, -1) @ layer["self_attn"]["wo"]

    hn = rms_norm(h, layer["pre_cross_norm"], cfg.norm_eps)
    qc = split_heads(hn @ layer["cross_attn"]["wq"], (b, s, cfg.num_heads, hd), 2)
    a = attention(qc, cross_k, cross_v, positions, enc_valid, causal=False, impl=cfg.attn_impl)
    h = h + a.reshape(b, s, -1) @ layer["cross_attn"]["wo"]
    return h + _mlp(layer, h, cfg), new_self


# ----------------------------------------------------------------------------
# Entry points
# ----------------------------------------------------------------------------

@_meshed
def forward_train(params: Dict, src: torch.Tensor, tgt: torch.Tensor, cfg: ModelConfig):
    """Teacher-forced training logits (B, S_tgt, V) f32: encode ``src``, then
    every decoder layer over the whole target, each recomputed in the
    backward (the reference's ``jax.checkpoint`` of the scanned decoder
    layer). No valid lengths, as in the reference. On the card the causal
    self attention takes the prefill kernel and its backward; the encoder
    and the cross attention stay on the plain non-causal paths, as in
    serving. The reference also recomputes its encoder layers; here they
    keep their activations, which changes memory and not the result."""
    _check(cfg)
    enc_out = encode(params, src, cfg)
    x = constrain_batch(embed_tokens(params["embed"], tgt))
    b, s = tgt.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    for i in range(cfg.num_layers):
        layer = layer_params(params["dec_layers"], i)

        def body(h, layer=layer):
            ck, cv = _cross_kv(layer, enc_out, cfg)
            return _dec_layer_apply(layer, h, positions, cfg, None, ck, cv, None, None)[0]

        x = _remat(body, True)(x)
    return logits_from_hidden(params, x, cfg)


@_meshed
def prefill_step(
    params: Dict,
    src: torch.Tensor,  # (B, S_src, d_model) frame embeddings
    tgt: torch.Tensor,  # (B, S_tgt) tokens
    cfg: ModelConfig,
    src_valid: Optional[torch.Tensor] = None,
    tgt_valid: Optional[torch.Tensor] = None,
):
    """Encode, then the teacher-forced target prefix. Returns (logits of
    each row's last valid target token (B, V), kv): ``self_k``/``self_v``
    ``(L, B, S_tgt, Hkv, Dh)``, ``cross_k``/``cross_v`` ``(L, B, S_src,
    Hkv, Dh)``."""
    _check(cfg)
    enc_out = encode(params, src, cfg, src_valid)
    x = constrain_batch(embed_tokens(params["embed"], tgt))
    b, s = tgt.shape
    dev = x.device
    positions = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
    tgt_valid = (_valid(tgt_valid, dev) if tgt_valid is not None
                 else torch.full((b,), s, dtype=torch.int32, device=dev))
    src_valid = _valid(src_valid, dev)
    leaves = {name: [] for name in ("self_k", "self_v", "cross_k", "cross_v")}
    for i in range(cfg.num_layers):
        layer = layer_params(params["dec_layers"], i)
        ck, cv = _cross_kv(layer, enc_out, cfg)
        x, (sk, sv) = _dec_layer_apply(layer, x, positions, cfg, None, ck, cv, src_valid,
                                       tgt_valid)
        for name, t in zip(leaves, (sk, sv, ck, cv), strict=True):
            leaves[name].append(t)
    last = _last_rows(x, tgt_valid.long() - 1)
    return logits_from_hidden(params, last, cfg), {n: torch.stack(t) for n, t in leaves.items()}


@_meshed
def decode_step(
    params: Dict,
    tokens: torch.Tensor,  # (B, 1)
    positions: torch.Tensor,  # (B,) current write position, below the self cache's length
    cfg: ModelConfig,
    cache: Dict,
    enc_valid: Optional[torch.Tensor] = None,  # (B,) encoder length; None = every cross row
):
    """Single-token decode. Returns (logits (B, V), cache with its self K/V
    written in place)."""
    _check(cfg)
    x = constrain_batch(embed_tokens(params["embed"], tokens))
    positions = positions.to(device=x.device, dtype=torch.int32)
    pos2 = positions[:, None]
    kv_valid = positions + 1
    enc_valid = _valid(enc_valid, x.device)
    for i in range(cfg.num_layers):
        x, _ = _dec_layer_apply(
            layer_params(params["dec_layers"], i), x, pos2, cfg,
            (cache["self_k"][i], cache["self_v"][i]), cache["cross_k"][i], cache["cross_v"][i],
            enc_valid, kv_valid,
        )
    return logits_from_hidden(params, x[:, 0], cfg), cache


def handoff(cfg: ModelConfig, kv: Dict, cache_or_max_len: Union[Dict, int]) -> Dict:
    """The tree `prefill_step` returned as a decode cache: its self K/V
    written into rows ``[0, S_tgt)`` of the self leaves (a new zeroed cache
    of ``max_len`` rows when given an int, else the given cache's, in
    place), and its cross K/V as the cross leaves, at exactly the encoder's
    length, so that a decode without ``enc_valid`` attends only real memory
    (ROADMAP C7). Returns the cache."""
    _check(cfg)
    sk = kv["self_k"]
    if isinstance(cache_or_max_len, int):
        shape = (*sk.shape[:2], cache_or_max_len, *sk.shape[3:])
        cache = {n: torch.zeros(shape, dtype=sk.dtype, device=sk.device)
                 for n in ("self_k", "self_v")}
    else:
        cache = cache_or_max_len
    s, m = sk.shape[2], cache["self_k"].shape[2]
    if s > m:
        raise ValueError(f"a target prefix of {s} rows does not fit a self cache of {m}")
    cache["self_k"][:, :, :s].copy_(sk)
    cache["self_v"][:, :, :s].copy_(kv["self_v"])
    cache["cross_k"], cache["cross_v"] = kv["cross_k"], kv["cross_v"]
    return cache


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int,
                 enc_len: int = DECODE_ENC_LEN) -> Dict:
    """{leaf: (shape, dtype-name)} of the decode cache, as the reference's."""
    _check(cfg)
    hd = cfg.resolved_head_dim
    kv_self = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, hd)
    kv_cross = (cfg.num_layers, batch, enc_len, cfg.num_kv_heads, hd)
    return dict(self_k=(kv_self, cfg.dtype), self_v=(kv_self, cfg.dtype),
                cross_k=(kv_cross, cfg.dtype), cross_v=(kv_cross, cfg.dtype))
