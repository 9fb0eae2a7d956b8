"""Roofline terms and bounds of the port on the H100 (port of
``repro.roofline.analysis``).

  compute term    = FLOPs / (chips * peak_FLOP/s)
  memory term     = bytes / (chips * HBM_bw)
  collective term = collective_bytes / (chips * link_bw)

FLOPs and bytes come from `op_stats` (the ops of one call of a port
function, the kernels by their own work), where the reference parses
compiled HLO. The reference also parses the collective bytes out of that
HLO (``parse_collective_bytes``); the port has no HLO, and
``collective_bytes_per_chip`` comes from the same count: `op_stats` records
every collective a call on a mesh issues, DTensor's own redistributions
included, at its bytes on the wire per rank (`op_stats.wire_bytes`, the
reference's ring model), as `launch.dryrun` does per cell; on one card it
is 0. ``collective_s`` keeps the reference's formula (every byte at the
chip's aggregate link rate); the dry-run records the bytes per mesh dim,
whose links differ (a 16-wide model axis spans two 8-GPU hosts).

`bound` is the least time the card could take for one call of known work,
the bound of every kernel row ``chip_smoke.py`` prints.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import torch

from repro_torch.kernels.ssd_scan.ops import work as ssd_work
from repro_torch.roofline.hw import H100, ChipSpec
from repro_torch.training.optimizer import tree_leaves


def bound(flops: float, nbytes: float, dtype: torch.dtype,
          hw: ChipSpec = H100) -> Tuple[float, str]:
    """(ms, what binds): the larger of ``flops`` at the card's peak for
    ``dtype`` (bf16 on the tensor cores, f32 outside them) and ``nbytes``
    at its HBM rate, and "operations" or "bytes" after the larger."""
    peak = {torch.bfloat16: hw.peak_flops_bf16, torch.float32: hw.peak_flops_f32}[dtype]
    t_ops = flops / peak
    t_bytes = nbytes / hw.hbm_bw
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_global: float
    bytes_global: float  # op-count bytes (unfused upper bound)
    collective_bytes_per_chip: float
    model_flops: float  # 6*N*D (train) / 2*N_active*tokens (inference)
    bytes_analytic_global: float = 0.0  # fused lower bound
    hw: ChipSpec = field(default_factory=lambda: H100)

    @property
    def compute_s(self) -> float:
        return self.flops_global / (self.chips * self.hw.peak_flops_bf16)

    @property
    def memory_s(self) -> float:
        """Memory term from the analytic (fused) model when available; the
        op-count number is an unfused upper bound (memory_s_hlo)."""
        b = self.bytes_analytic_global or self.bytes_global
        return b / (self.chips * self.hw.hbm_bw)

    @property
    def memory_s_hlo(self) -> float:
        return self.bytes_global / (self.chips * self.hw.hbm_bw)

    @property
    def collective_s(self) -> float:
        # per-chip collective bytes over per-chip aggregate link bandwidth
        return self.collective_bytes_per_chip / (self.hw.ici_link_bw * self.hw.ici_links)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_frac(self) -> float:
        """MODEL_FLOPS / op-count FLOPs — catches remat/redundancy waste."""
        if self.flops_global <= 0:
            return 0.0
        return self.model_flops / self.flops_global

    @property
    def roofline_frac(self) -> float:
        """Fraction of the compute roofline the dominant-bound step achieves
        on useful model flops."""
        t = self.step_time_bound_s
        if t <= 0:
            return 0.0
        return (self.model_flops / t) / (self.chips * self.hw.peak_flops_bf16)

    def as_dict(self) -> Dict:
        return dict(
            arch=self.arch,
            shape=self.shape,
            mesh=self.mesh,
            chips=self.chips,
            flops_global=self.flops_global,
            bytes_global=self.bytes_global,
            bytes_analytic_global=self.bytes_analytic_global,
            collective_bytes_per_chip=self.collective_bytes_per_chip,
            model_flops=self.model_flops,
            compute_s=self.compute_s,
            memory_s=self.memory_s,
            memory_s_hlo=self.memory_s_hlo,
            collective_s=self.collective_s,
            dominant=self.dominant,
            useful_flops_frac=self.useful_flops_frac,
            roofline_frac=self.roofline_frac,
        )


def analytic_memory_bytes(cfg, spec, n_micro: int = 8, windowed: bool = False) -> float:
    """Fused lower-bound HBM traffic per step (global bytes), the
    reference's formulas as they are.

    Counts what a well-fused program must stream:

      train:   weight reads (fwd+bwd per microbatch) + optimizer traffic +
               C materialized activations per layer + attention scores
               (naive path: quadratic; flash kernels remove this term)
      prefill: weight read + activations + scores + KV output
      decode:  weight read + full KV-cache read + GQA expansion
    """
    n_total = cfg.count_params()
    n_active = cfg.count_active_params()
    tokens = spec.global_batch * spec.seq_len
    d = max(cfg.d_model, 1)
    L = max(cfg.num_layers, 1)
    hq = max(cfg.num_heads, 1)
    hkv = max(cfg.num_kv_heads, 1)
    dh = cfg.resolved_head_dim

    def attn_layers() -> int:
        if cfg.family == "hybrid":
            return cfg.num_layers // max(1, cfg.hybrid_period)
        if cfg.family == "ssm":
            return 0
        return L

    if spec.kind == "train":
        micro = n_micro if spec.global_batch % n_micro == 0 else 1
        w = 2.0 * n_total * (2 * micro)  # bf16 read fwd+bwd per microbatch
        opt = 20.0 * n_total  # f32 m/v read+write + param read/write
        acts = 12.0 * L * tokens * d * 2.0  # ~12 materialized tensors/layer (remat incl.)
        # naive attention scores fwd + bwd recompute (f32), per attn layer
        scores = 3.0 * attn_layers() * spec.global_batch * hq * (spec.seq_len ** 2) * 4.0
        if cfg.is_encdec:
            scores *= 0.75  # half-length enc/dec sequences
        return w + opt + acts + scores

    if spec.kind == "prefill":
        w = 2.0 * n_active
        acts = 8.0 * L * tokens * d * 2.0
        # blockwise (flash-style) attention path at 32K: no quadratic term
        kv_out = 2.0 * attn_layers() * tokens * 2 * hkv * dh * 2.0
        return w + acts + kv_out

    # decode: one token per sequence
    w = 2.0 * n_active
    if (windowed and cfg.alternate_local_global and cfg.sliding_window
            and spec.seq_len > cfg.sliding_window):
        # windowed ring cache: half the layers read only the window
        per_layer_tokens = (spec.seq_len + cfg.sliding_window) / 2.0
    else:
        per_layer_tokens = float(spec.seq_len)
    kv_read = 2.0 * attn_layers() * spec.global_batch * per_layer_tokens * hkv * dh * 2.0
    if cfg.family in ("ssm", "hybrid"):
        ssm_state = (
            2.0 * L * spec.global_batch * cfg.ssm_num_heads * cfg.ssm_head_dim
            * cfg.ssm_state_dim * 4.0
        )
        kv_read += 2.0 * ssm_state
    acts = 6.0 * L * spec.global_batch * d * 2.0
    return w + kv_read + acts


def model_flops_for(cfg, spec) -> float:
    """MODEL_FLOPS: 6*N*D for training; forward-only for inference shapes."""
    n_active = cfg.count_active_params()
    if spec.kind == "train":
        tokens = spec.global_batch * spec.seq_len
        return 6.0 * n_active * tokens
    if spec.kind == "prefill":
        tokens = spec.global_batch * spec.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * spec.global_batch


def train_flops(cfg, params, tokens: int, seq_len: int) -> float:
    """The port's model FLOPs of one training step at ``tokens`` tokens in
    sequences of ``seq_len``, forward and backward, no recompute counted:
    6 N per token, N counting zamba2's shared block once per use
    (count_params counts it once; its size is read off ``params``, real
    tensors or `Model.param_struct`'s); causal attention's 6 L H Dh S per
    token, L the attention layers (the shared block's uses); and for the
    Mamba2 layers three times the SSD scan's forward operations (the
    forward once, the backward twice)."""
    n = cfg.count_params()
    attn = ssm = 0
    if cfg.family == "hybrid":
        attn, ssm = cfg.num_layers // cfg.hybrid_period, cfg.num_layers
        n += (attn - 1) * sum(t.numel() for t in tree_leaves(params["shared_attn"]))
    elif cfg.family == "ssm":
        ssm = cfg.num_layers
    else:
        attn = cfg.num_layers
    flops = tokens * (6 * n + 6 * attn * cfg.num_heads * cfg.resolved_head_dim * seq_len)
    if ssm:
        scan, _ = ssd_work(tokens // seq_len, seq_len, cfg.ssm_num_heads, cfg.ssm_head_dim,
                           cfg.ssm_state_dim, cfg.ssm_chunk, 2)
        flops += 3 * ssm * scan
    return flops
