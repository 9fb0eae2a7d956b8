"""Model configuration schema (a copy of ``repro.configs.base``; of the
derived counts, those the model code, the parameter counts and the
roofline's shape cells read).

Every assigned architecture is expressed as a ``ModelConfig``, a frozen
dataclass, so the port reads the same architectures as the reference.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    source: str = ""  # citation tag from the assignment table

    # transformer trunk
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0  # 0 -> d_model // num_heads
    d_ff: int = 0
    vocab_size: int = 0

    # MoE
    num_experts: int = 0
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    moe_group_size: int = 2048  # tokens per dispatch group

    # attention variants
    sliding_window: int = 0  # 0 = all-global
    alternate_local_global: bool = False  # gemma2: even layers local
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    rope_theta: float = 10_000.0
    use_qk_norm: bool = False

    # SSM (mamba2 / SSD)
    ssm_state_dim: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    ssm_ngroups: int = 1

    # hybrid (zamba2-style): one shared attention block every `hybrid_period`
    # ssm layers
    hybrid_period: int = 0

    # encoder-decoder
    enc_layers: int = 0  # >0 => encdec; num_layers is the decoder depth

    # io / misc
    attn_impl: str = "auto"  # auto | naive | blockwise | pallas (flash kernels)
    input_mode: str = "tokens"  # tokens | embeddings (stubbed modality frontend)
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    act: str = "silu"  # silu | gelu
    dtype: str = "bfloat16"

    # notes recorded into DESIGN/EXPERIMENTS artifacts
    notes: str = ""

    # ----------------------------------------------------------------- derived
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    @property
    def q_per_kv(self) -> int:
        return max(1, self.num_heads // max(1, self.num_kv_heads))

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic (SSM/hybrid) archs run the long_500k shape."""
        return self.family in ("ssm", "hybrid")

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def moe_capacity(self, tokens_per_group: int) -> int:
        import math

        cap = math.ceil(
            tokens_per_group * self.experts_per_token * self.capacity_factor / max(1, self.num_experts)
        )
        # round up to a multiple of 8 for tiling friendliness
        return max(8, ((cap + 7) // 8) * 8)

    # -------------------------------------------------------------- param math
    def count_params(self) -> int:
        """Analytic parameter count (embedding + trunk + head).

        Used for MODEL_FLOPS = 6*N*D roofline bookkeeping; close to exact for
        the simplified blocks we implement.
        """
        d, hd = self.d_model, self.resolved_head_dim
        n_q = self.num_heads * hd
        n_kv = self.num_kv_heads * hd

        def attn_params() -> int:
            return d * n_q + 2 * d * n_kv + n_q * d

        def dense_mlp() -> int:
            return 3 * d * self.d_ff  # SwiGLU: gate, up, down

        def moe_mlp() -> int:
            return self.num_experts * 3 * d * self.d_ff + d * self.num_experts

        def ssm_params() -> int:
            di = self.ssm_d_inner
            n = self.ssm_state_dim
            g = self.ssm_ngroups
            conv_ch = di + 2 * g * n
            in_proj = d * (2 * di + 2 * g * n + self.ssm_num_heads)
            conv = conv_ch * self.ssm_conv_width
            out_proj = di * d
            extra = self.ssm_num_heads * 2 + di  # A, D, norm
            return in_proj + conv + out_proj + extra

        total = self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d

        norms = 2 * d  # per layer (pre-attn + pre-mlp), approximated below

        if self.family in ("dense", "vlm"):
            total += self.num_layers * (attn_params() + dense_mlp() + norms)
        elif self.family == "moe":
            total += self.num_layers * (attn_params() + moe_mlp() + norms)
        elif self.family == "ssm":
            total += self.num_layers * (ssm_params() + norms)
        elif self.family == "hybrid":
            total += self.num_layers * (ssm_params() + norms)
            n_shared = 1  # one shared attention+mlp block (zamba2-style)
            total += n_shared * (attn_params() + dense_mlp() + norms)
        elif self.family == "encdec":
            # encoder self-attn + mlp; decoder self + cross + mlp
            total += self.enc_layers * (attn_params() + dense_mlp() + norms)
            total += self.num_layers * (2 * attn_params() + dense_mlp() + 3 * d)
        total += d  # final norm
        return int(total)

    def count_active_params(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if self.family != "moe":
            return self.count_params()
        d = self.d_model
        inactive = (self.num_experts - self.experts_per_token) * 3 * d * self.d_ff
        return int(self.count_params() - self.num_layers * inactive)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests."""
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=min(cfg.num_layers, 2),
        d_model=64,
        d_ff=128,
        vocab_size=256,
        moe_group_size=32,
    )
    if cfg.num_heads:
        kw.update(num_heads=4, num_kv_heads=2 if cfg.num_kv_heads < cfg.num_heads else 4, head_dim=16)
    if cfg.num_experts:
        kw.update(num_experts=4, experts_per_token=2)
    if cfg.ssm_state_dim:
        kw.update(ssm_state_dim=16, ssm_head_dim=16, ssm_chunk=16)
    if cfg.hybrid_period:
        kw.update(hybrid_period=2, num_layers=4)
    if cfg.enc_layers:
        kw.update(enc_layers=2, num_layers=2)
    if cfg.sliding_window:
        kw.update(sliding_window=32)
    return cfg.replace(**kw)
