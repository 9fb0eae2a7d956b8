"""Model API over the dense, moe, vlm, ssm, hybrid and encdec families (port
of ``repro.models.model``).

  model = build_model(cfg)
  params = model.init(seed, device="cuda")
  logits, kv = model.prefill(params, batch)    # batch["inputs"]: tokens, or
                                               # embeddings for input_mode="embeddings";
                                               # encdec: batch["src"], batch["tgt"]
  logits, cache = model.decode(params, tokens, positions, cache)
  cache = model.init_cache(batch, max_len, device="cuda")   # zeros, allocated; the ring
                                                          # cache where cache_shapes picks it
  spec  = cache_struct(cfg, batch, max_len)                 # meta tensors only
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.layers import dtype_of


def _cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> Dict:
    if cfg.is_encdec:
        return encdec.cache_shapes(cfg, batch, max_len)
    return transformer.cache_shapes(cfg, batch, max_len)


def cache_struct(cfg: ModelConfig, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
    """Cache leaves as tensors on the ``meta`` device: shapes and dtypes,
    no allocation (the counterpart of JAX's ShapeDtypeStruct tree)."""
    return {
        name: torch.empty(shape, dtype=dtype_of(dt), device="meta")
        for name, (shape, dt) in _cache_shapes(cfg, batch, max_len).items()
    }


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, seed: int = 0, device: DeviceLike = "cuda") -> Dict:
        if self.cfg.is_encdec:
            return encdec.init_params(self.cfg, seed, device)
        return transformer.init_params(self.cfg, seed, device)

    def init_cache(self, batch: int, max_len: int, device: DeviceLike = "cuda") -> Dict:
        dev = resolve_device(device)
        return {
            name: torch.zeros(shape, dtype=dtype_of(dt), device=dev)
            for name, (shape, dt) in _cache_shapes(self.cfg, batch, max_len).items()
        }

    def prefill(self, params: Dict, batch: Dict, valid_len: Optional[torch.Tensor] = None):
        if self.cfg.is_encdec:
            return encdec.prefill_step(params, batch["src"], batch["tgt"], self.cfg,
                                       tgt_valid=valid_len)
        return transformer.prefill_step(params, batch["inputs"], self.cfg, valid_len)

    def decode(self, params: Dict, tokens: torch.Tensor, positions: torch.Tensor, cache: Dict):
        if self.cfg.is_encdec:
            return encdec.decode_step(params, tokens, positions, self.cfg, cache)
        return transformer.decode_step(params, tokens, positions, self.cfg, cache)


def build_model(cfg: ModelConfig) -> Model:
    transformer.check_supported(cfg)
    return Model(cfg)
