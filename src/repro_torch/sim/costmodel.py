"""Step-time cost model of the discrete-event simulator, also the serving
session's KV-handoff pricing (a copy of ``repro.sim.costmodel`` without
``TPUCostModel``, whose coefficients are TPU v5e's).

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


PAPER_COST_MODEL = CalibratedCostModel()


def check_calibration(cm: CalibratedCostModel = PAPER_COST_MODEL) -> dict:
    """Returns the paper's calibration points vs the model's predictions."""
    return {
        "prefill_8k": (cm.prefill_time(8192), 0.4004),
        "prefill_128k": (cm.prefill_time(131072), 8.8),
        "decode_8k_b1": (cm.decode_step_time([8192]), 0.0110),
        "decode_128k_b1": (cm.decode_step_time([131072]), 0.0403),
    }
