"""Carry the JAX package's parameters across to the port.

``params_from_jax`` takes the JAX parameter pytree with its leaves as numpy
arrays (``jax.tree.map(np.asarray, params)``: stacked ``(L, ...)`` layer
weights, ``(in, out)`` matrices) and returns the same tree as tensors on
``device``, so both packages compute with identical weights.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import ATTN_FAMILIES, check_supported, hybrid_blocks


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # torch.from_numpy rejects ml_dtypes.bfloat16: move the bits as uint16
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_jax(np_params: Dict[str, Any], cfg: ModelConfig, device: DeviceLike = "cuda"):
    """The JAX pytree of numpy arrays as a dict of tensors on ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _tensor(node, dev)

    params = conv(np_params)
    if cfg.is_encdec:
        _check_encdec(params, cfg)
        return params
    want = {"embed", "final_norm", "layers"} | ({"lm_head"} if not cfg.tie_embeddings else set())
    if cfg.family == "hybrid":
        want.add("shared_attn")
    if set(params) != want:
        raise ValueError(f"parameter tree has keys {sorted(params)}, expected {sorted(want)}")
    # the layer axes: (L,) for the attention families and ssm, (super-blocks,
    # per block) for hybrid; every stacked leaf of the layers carries them
    layers = params["layers"]
    if cfg.family in ATTN_FAMILIES:
        ffn = "moe" if cfg.family == "moe" else "mlp"
        if set(layers) != {"attn", ffn, "pre_attn_norm", "pre_mlp_norm"}:
            raise ValueError(f"layer tree has keys {sorted(layers)}, config {cfg.name} is "
                             f"{cfg.family!r} (expected attn, {ffn} and the two norms)")
        expect = (cfg.num_layers,)
    elif cfg.family == "ssm":
        expect = (cfg.num_layers,)
    else:
        expect = hybrid_blocks(cfg)
    _check_layer_axes(layers, expect, cfg)
    return params


def _check_layer_axes(layers: Dict, expect, cfg: ModelConfig, what: str = "layer") -> None:
    for leaf in _leaves(layers):
        lead = tuple(leaf.shape[: len(expect)])
        if lead != tuple(expect):
            raise ValueError(f"parameter tree has {what} axes {lead}, config {cfg.name} "
                             f"has {tuple(expect)}")


def _check_encdec(params: Dict, cfg: ModelConfig) -> None:
    """The encoder-decoder tree: its keys, an encoder layer's and a decoder
    layer's sub-trees (self, cross, mlp), and the layer axes of both stacks."""
    want = {"embed", "enc_layers", "dec_layers", "enc_final_norm", "final_norm"}
    if not cfg.tie_embeddings:
        want.add("lm_head")
    if set(params) != want:
        raise ValueError(f"parameter tree has keys {sorted(params)}, expected {sorted(want)}")
    attn = {"wq", "wk", "wv", "wo"} | ({"q_norm", "k_norm"} if cfg.use_qk_norm else set())
    mlp = {"w_gate", "w_up", "w_down"}
    for name, n, subs, norms in (
        ("enc_layers", cfg.enc_layers, dict(attn=attn, mlp=mlp), ("pre_attn_norm", "pre_mlp_norm")),
        ("dec_layers", cfg.num_layers, dict(self_attn=attn, cross_attn=attn, mlp=mlp),
         ("pre_self_norm", "pre_cross_norm", "pre_mlp_norm")),
    ):
        tree = params[name]
        if set(tree) != {*subs, *norms}:
            raise ValueError(f"{name} has keys {sorted(tree)}, expected {sorted({*subs, *norms})}")
        for sub, keys in subs.items():
            got = set(tree[sub]) if isinstance(tree[sub], dict) else set()
            if got != keys:
                raise ValueError(f"{name}.{sub} has keys {sorted(got)}, expected {sorted(keys)}")
        _check_layer_axes(tree, (n,), cfg, f"{name} layer")


def _leaves(tree: Dict):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))
