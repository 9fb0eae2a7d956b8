"""Assigned input shapes and meta-tensor stand-ins for the roofline (port of
``repro.configs.shapes``).

Four shape cells per architecture (40 total):
  train_4k     seq_len=4096   global_batch=256  -> the training step
  prefill_32k  seq_len=32768  global_batch=32   -> Model.prefill
  decode_32k   seq_len=32768  global_batch=128  -> Model.decode (1 new
               token against a KV cache of seq_len)
  long_500k    seq_len=524288 global_batch=1    -> Model.decode; SSM/hybrid only

No tensor is allocated here: every leaf is a tensor on the ``meta`` device,
the counterpart of the reference's ``jax.ShapeDtypeStruct``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

ALL_SHAPES = {s.name: s for s in [TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K]}


def shape_applicable(cfg: ModelConfig, spec: ShapeSpec) -> Optional[str]:
    """Return None if (cfg, spec) should run; else a skip reason string."""
    if spec.name == "long_500k" and not cfg.supports_long_context:
        return (
            "long_500k requires sub-quadratic attention; "
            f"{cfg.name} ({cfg.family}) uses full attention — skipped per "
            "assignment (noted in DESIGN.md)"
        )
    return None


# --------------------------------------------------------------------------
# Meta-tensor builders. These mirror the trees the step functions take.
# --------------------------------------------------------------------------

def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype, device="meta")


def token_or_embed_spec(cfg: ModelConfig, batch: int, seq: int) -> torch.Tensor:
    if cfg.input_mode == "embeddings":
        return _sds((batch, seq, cfg.d_model), torch.bfloat16)
    return _sds((batch, seq), torch.int32)


def train_input_specs(cfg: ModelConfig, spec: ShapeSpec) -> Dict:
    b, s = spec.global_batch, spec.seq_len
    if cfg.is_encdec:
        half = s // 2
        return dict(
            src=token_or_embed_spec(cfg, b, half),
            tgt=_sds((b, half), torch.int32),
            labels=_sds((b, half), torch.int32),
        )
    return dict(
        inputs=token_or_embed_spec(cfg, b, s),
        labels=_sds((b, s), torch.int32),
    )


def prefill_input_specs(cfg: ModelConfig, spec: ShapeSpec) -> Dict:
    b, s = spec.global_batch, spec.seq_len
    if cfg.is_encdec:
        half = s // 2
        return dict(
            src=token_or_embed_spec(cfg, b, half),
            tgt=_sds((b, half), torch.int32),
        )
    return dict(inputs=token_or_embed_spec(cfg, b, s))


def decode_input_specs(cfg: ModelConfig, spec: ShapeSpec) -> Dict:
    """One-token decode step against a KV cache (or SSM state) of seq_len."""
    b, s = spec.global_batch, spec.seq_len
    return dict(
        tokens=_sds((b, 1), torch.int32),
        positions=_sds((b,), torch.int32),
        cache=cache_specs(cfg, b, s),
    )


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> Dict:
    """Meta-tensor tree matching models.model.Model.init_cache."""
    from repro_torch.models.model import cache_struct  # late import: models import configs

    return cache_struct(cfg, batch, max_len)


def input_specs(cfg: ModelConfig, spec: ShapeSpec) -> Dict:
    if spec.kind == "train":
        return train_input_specs(cfg, spec)
    if spec.kind == "prefill":
        return prefill_input_specs(cfg, spec)
    return decode_input_specs(cfg, spec)
