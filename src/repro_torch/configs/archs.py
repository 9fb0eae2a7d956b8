"""The 10 assigned architectures + the paper's own model (proxy).

Exact values from the assignment table; ``source`` records provenance tier.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

GROK1_314B = ModelConfig(
    name="grok-1-314b",
    family="moe",
    source="hf:xai-org/grok-1; unverified",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    num_experts=8,
    experts_per_token=2,
    tie_embeddings=True,
    act="gelu",
    attn_logit_softcap=30.0,  # grok uses attn logit softcapping
    notes="MoE 8e top-2",
)

PHI35_MOE_42B = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    source="hf:microsoft/Phi-3.5-MoE-instruct; hf",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    num_experts=16,
    experts_per_token=2,
    tie_embeddings=False,
    notes="MoE 16e top-2",
)

GEMMA2_9B = ModelConfig(
    name="gemma2-9b",
    family="dense",
    source="arXiv:2408.00118; hf",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    sliding_window=4096,
    alternate_local_global=True,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    tie_embeddings=True,
    act="gelu",
    notes="local+global alternating, logit softcap",
)

LLAMA3_8B = ModelConfig(
    name="llama3-8b",
    family="dense",
    source="arXiv:2407.21783; unverified",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500_000.0,
    tie_embeddings=False,
    notes="GQA 128k vocab",
)

MINICPM_2B = ModelConfig(
    name="minicpm-2b",
    family="dense",
    source="arXiv:2404.06395; hf",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    tie_embeddings=True,
    notes="WSD schedule (arch=llama-like); MHA",
)

COMMAND_R_35B = ModelConfig(
    name="command-r-35b",
    family="dense",
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    tie_embeddings=True,
    notes="GQA, no-bias",
)

CHAMELEON_34B = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    source="arXiv:2405.09818; unverified",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    use_qk_norm=True,
    input_mode="embeddings",  # early-fusion VQ tokens; frontend stubbed
    tie_embeddings=False,
    notes="early-fusion, VQ image tokens; modality frontend is a stub "
    "(input_specs provides precomputed patch embeddings)",
)

MAMBA2_130M = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    source="arXiv:2405.21060; unverified",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state_dim=128,
    ssm_expand=2,
    ssm_head_dim=64,
    tie_embeddings=True,
    notes="SSD (state-space duality); attn-free",
)

ZAMBA2_27B = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    source="arXiv:2411.15242; hf",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state_dim=64,
    ssm_expand=2,
    ssm_head_dim=64,
    hybrid_period=6,  # one shared attention block every 6 mamba2 layers
    tie_embeddings=True,
    notes="Mamba2 + shared attn blocks",
)

SEAMLESS_M4T_MEDIUM = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    source="arXiv:2308.11596; hf",
    num_layers=12,
    enc_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    input_mode="embeddings",  # audio frontend stubbed (precomputed frames)
    tie_embeddings=True,
    act="gelu",
    notes="enc-dec, multimodal; modality frontend is a stub",
)

# The paper's own evaluation model (MiniMax-M2.5, 229B MoE). Public config is
# not released; this proxy matches the published headline stats (229B total,
# ~10B active) and is used for the sim cost model + an extra dry-run config.
PAPER_MINIMAX_M25_PROXY = ModelConfig(
    name="minimax-m2.5-proxy",
    family="moe",
    source="hf:MiniMaxAI/MiniMax-M2.5 (proxy; config unreleased)",
    num_layers=62,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=1536,  # per-expert ff (fine-grained experts)
    vocab_size=200064,
    num_experts=128,
    experts_per_token=4,
    tie_embeddings=False,
    notes="proxy config for the paper's eval model (229B-A10B class)",
)

ALL_ARCHS = {
    c.name: c
    for c in [
        GROK1_314B,
        PHI35_MOE_42B,
        GEMMA2_9B,
        LLAMA3_8B,
        MINICPM_2B,
        COMMAND_R_35B,
        CHAMELEON_34B,
        MAMBA2_130M,
        ZAMBA2_27B,
        SEAMLESS_M4T_MEDIUM,
        PAPER_MINIMAX_M25_PROXY,
    ]
}

ASSIGNED = [n for n in ALL_ARCHS if n != "minimax-m2.5-proxy"]
