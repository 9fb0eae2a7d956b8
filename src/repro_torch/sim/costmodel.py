"""Step-time cost model of the discrete-event simulator, also the serving
session's KV-handoff pricing (a copy of ``repro.sim.costmodel``; in place
of ``TPUCostModel``, whose coefficients are TPU v5e's, `ChipCostModel`
derives them from a `roofline.hw.ChipSpec`, the H100 by default).

Calibrated to the paper's measured numbers (MiniMax-M2.5, 4xH200 TP4):
  prefill:  8K -> 400.4 ms, 128K -> 8.8 s            (paper §2.2)
  decode @bsz=1:  8K -> 11.0 ms, 128K -> 40.3 ms     (paper Fig. 1b)

Decode batching follows the paper's explicit premise: "the batch step time
is determined by the slowest request" (§2.2) — i.e. a *max*-based straggler
model plus a small per-request term, matching the paper's LUT[bsz, max_seq]
parameterization.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.roofline.hw import H100, ChipSpec

@dataclass(frozen=True)
class CalibratedCostModel:
    """Fit to the paper's published measurements."""

    # prefill t(n) = p0 + p1*n + p2*n^2   (compute-linear + attention-quadratic)
    p0: float = 0.020
    p1: float = 4.5063e-5
    p2: float = 1.6724e-10
    # per-chunk fixed overhead for chunked prefill steps
    p_chunk: float = 0.004

    # decode t(bsz, seqs) = d0 + d1*bsz + d2*max(seqs) + d3*sum(seqs)
    # d0+d1: fixed weight-read + per-request dispatch/sampling overhead.
    # d2: straggler latency (slowest request's attention, paper §2.2);
    # d3: aggregate KV bandwidth across the batch. d2+d3 calibrated so
    # bsz=1 matches the paper (11.0 ms @8K, 40.3 ms @128K).
    d0: float = 0.00874
    d1: float = 0.00031
    d2: float = 2.2000e-7
    d3: float = 0.1845e-7

    # KV transfer prefill -> decode instance
    transfer_lat: float = 0.002  # fixed latency
    kv_bytes_per_token: float = 500e3  # KV footprint per token
    transfer_bw: float = 900e9  # NVLink (paper testbed); ICI on TPU

    # ------------------------------------------------------------- prefill
    def prefill_time(self, n_tokens: int) -> float:
        """Whole-prompt prefill from scratch."""
        return self.p0 + self.p1 * n_tokens + self.p2 * n_tokens * n_tokens

    def prefill_chunk_time(self, chunks: Sequence) -> float:
        """One chunked-prefill step processing [(chunk_len, ctx_offset), ...].

        Attention cost of a chunk at context offset o is quadratic-difference:
        p2 * ((o+c)^2 - o^2); linear (MLP) cost is p1 * c.
        """
        t = self.p_chunk
        for c, o in chunks:
            t += self.p1 * c + self.p2 * (float(o + c) ** 2 - float(o) ** 2)
        return t

    def prefill_throughput_seed(self) -> float:
        """Initial mu_prefill (tokens/sec) before any observations."""
        return 1.0 / self.p1

    # -------------------------------------------------------------- decode
    def decode_step_time(self, seqs: Sequence[int]) -> float:
        """True per-step time for a batch with the given sequence lengths."""
        if not seqs:
            return 0.0
        return (
            self.d0
            + self.d1 * len(seqs)
            + self.d2 * max(seqs)
            + self.d3 * sum(seqs)
        )

    def decode_lut_seed(self, bsz: int, seq: int) -> float:
        """Analytic LUT entry: homogeneous batch at (bsz, seq) — the paper's
        LUT[bsz, seq] parameterization."""
        return self.d0 + self.d1 * bsz + (self.d2 + self.d3 * bsz) * seq

    # ------------------------------------------------------------ transfer
    def transfer_time(self, n_tokens: int) -> float:
        return self.transfer_lat + n_tokens * self.kv_bytes_per_token / self.transfer_bw


@dataclass(frozen=True)
class ChipCostModel:
    """Roofline-derived coefficients for a ModelConfig on ``chips`` chips of
    ``hw`` (the reference's ``TPUCostModel`` on any `ChipSpec`).

    decode:  d0 = active weight bytes / (chips * HBM_bw)   (weight read)
             d2 = per-token KV bytes / (chips * HBM_bw)    (KV read, straggler)
             d1 = small dispatch/sampling overhead
    prefill: p1 = 2 * N_active / (chips * peak_flops)      (GEMM-bound)
             p2 = attention flops coefficient
    transfer: every chip-to-chip link of one chip (the reference: 4 ICI links)
    """

    cfg: ModelConfig
    chips: int = 4
    hw: ChipSpec = H100
    mfu: float = 0.5  # achievable fraction for prefill GEMMs
    membw_frac: float = 0.7  # achievable HBM fraction for decode

    def _active_bytes(self) -> float:
        return self.cfg.count_active_params() * 2.0  # bf16

    def kv_bytes_per_token(self) -> float:
        c = self.cfg
        if c.family == "ssm":
            return 0.0  # constant state, no per-token KV
        per_layer = 2 * c.num_kv_heads * c.resolved_head_dim * 2.0
        n_attn = c.num_layers if c.family != "hybrid" else c.num_layers // max(1, c.hybrid_period)
        return per_layer * n_attn

    def to_calibrated(self) -> CalibratedCostModel:
        c = self.cfg
        bw = self.chips * self.hw.hbm_bw * self.membw_frac
        flops = self.chips * self.hw.peak_flops_bf16 * self.mfu
        n_act = c.count_active_params()
        d0 = self._active_bytes() / bw
        d2 = self.kv_bytes_per_token() / bw
        p1 = 2.0 * n_act / flops
        # attention quadratic term: 2 heads_flops per (q, kv) pair
        if c.num_heads:
            attn_per_pair = 4.0 * c.num_heads * c.resolved_head_dim * (
                c.num_layers if c.family != "hybrid" else c.num_layers // max(1, c.hybrid_period)
            )
        else:
            attn_per_pair = 0.0
        p2 = attn_per_pair / flops
        return CalibratedCostModel(
            p0=0.005,
            p1=p1,
            p2=p2,
            p_chunk=0.002,
            d0=d0,
            d1=2e-5,
            d2=d2,
            d3=0.0,
            kv_bytes_per_token=self.kv_bytes_per_token(),
            transfer_bw=self.hw.ici_link_bw * self.hw.ici_links,
            transfer_lat=0.001,
        )


PAPER_COST_MODEL = CalibratedCostModel()


def check_calibration(cm: CalibratedCostModel = PAPER_COST_MODEL) -> dict:
    """Returns the paper's calibration points vs the model's predictions."""
    return {
        "prefill_8k": (cm.prefill_time(8192), 0.4004),
        "prefill_128k": (cm.prefill_time(131072), 8.8),
        "decode_8k_b1": (cm.decode_step_time([8192]), 0.0110),
        "decode_128k_b1": (cm.decode_step_time([131072]), 0.0403),
    }
