"""Model API over the dense, moe, vlm, ssm, hybrid and encdec families (port
of ``repro.models.model``).

  model = build_model(cfg)
  params = model.init(seed, device="cuda")
  logits = model.forward_train(params, batch)   # (B, S, V) f32
  loss = model.loss(params, batch)              # batch["labels"]: -100 is ignored
  logits, kv = model.prefill(params, batch)    # batch["inputs"]: tokens, or
                                               # embeddings for input_mode="embeddings";
                                               # encdec: batch["src"], batch["tgt"]
  logits, cache = model.decode(params, tokens, positions, cache)
  cache = model.init_cache(batch, max_len, device="cuda")   # zeros, allocated; the ring
                                                          # cache where cache_shapes picks it
  spec  = cache_struct(cfg, batch, max_len)                 # meta tensors only
  tree  = model.param_struct()                              # meta tensors only
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

    def param_struct(self) -> Dict:
        """The parameter tree as tensors on the ``meta`` device: shapes and
        dtypes, no allocation (the counterpart of JAX's ``eval_shape`` of
        ``init``), built by the tree builder that `init` draws through."""
        meta = torch.device("meta")
        if self.cfg.is_encdec:
            return encdec.param_tree(self.cfg, None, meta)
        return transformer.param_tree(self.cfg, None, meta)

    def init_cache(self, batch: int, max_len: int, device: DeviceLike = "cuda") -> Dict:
        dev = resolve_device(device)
        return {
            name: torch.zeros(shape, dtype=dtype_of(dt), device=dev)
            for name, (shape, dt) in _cache_shapes(self.cfg, batch, max_len).items()
        }

    def forward_train(self, params: Dict, batch: Dict, remat: bool = True) -> torch.Tensor:
        if self.cfg.is_encdec:
            return encdec.forward_train(params, batch["src"], batch["tgt"], self.cfg)
        return transformer.forward_train(params, batch["inputs"], self.cfg, remat=remat)

    def loss(self, params: Dict, batch: Dict, remat: bool = True) -> torch.Tensor:
        """Mean next-token NLL over the labels >= 0 (-100 marks an ignored
        position), as the reference. The reference gathers at -100 too (JAX
        wraps the index and the mask zeroes it); ``torch.gather`` raises on
        it, so the labels are clamped to >= 0 first."""
        logits = self.forward_train(params, batch, remat=remat)
        labels = batch["labels"]
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, labels.clamp(min=0).long()[..., None])[..., 0]
        mask = (labels >= 0).float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)

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
