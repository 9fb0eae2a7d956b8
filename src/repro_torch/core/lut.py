"""Step-time lookup table (paper §3.2): LUT[batch_size, seq_len] -> seconds.

Profiled offline ("mean decode step time over 100 profiling runs per
configuration") and updated online with the historical mean of observed step
times per (batch-bucket, seq-bucket) cell. Unseen cells fall back to an
analytic model (roofline-derived on TPU — see sim/costmodel.py) so lookups
are always defined.
"""
from __future__ import annotations

from bisect import bisect_right
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np


def default_bsz_buckets(max_bsz: int = 256) -> List[int]:
    out = [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256]
    return [b for b in out if b <= max_bsz] or [1]


def default_seq_buckets(max_seq: int = 1 << 20) -> List[int]:
    out = []
    s = 512
    while s <= max_seq:
        out.append(s)
        s *= 2
    return out


@dataclass
class StepTimeLUT:
    """(batch, seq) -> per-step decode time with online running-mean updates."""

    analytic: Callable[[int, int], float]  # (bsz, seq) -> seconds (fallback/seed)
    bsz_buckets: List[int] = field(default_factory=default_bsz_buckets)
    seq_buckets: List[int] = field(default_factory=default_seq_buckets)
    seed_offline: bool = True  # paper: offline profile pre-populates the LUT

    def __post_init__(self) -> None:
        nb, ns = len(self.bsz_buckets), len(self.seq_buckets)
        self.mean = np.zeros((nb, ns))
        self.count = np.zeros((nb, ns), dtype=np.int64)
        if self.seed_offline:
            for i, b in enumerate(self.bsz_buckets):
                for j, s in enumerate(self.seq_buckets):
                    self.mean[i, j] = self.analytic(b, s)
                    self.count[i, j] = 1  # offline profile counts as one obs

    # ------------------------------------------------------------- bucketing
    def _bidx(self, bsz: int) -> int:
        i = bisect_right(self.bsz_buckets, max(1, bsz)) - 1
        return min(max(i, 0), len(self.bsz_buckets) - 1)

    def _sidx(self, seq: int) -> int:
        i = bisect_right(self.seq_buckets, max(1, seq)) - 1
        return min(max(i, 0), len(self.seq_buckets) - 1)

    # --------------------------------------------------------------- queries
    def lookup(self, bsz: int, seq: int) -> float:
        i, j = self._bidx(bsz), self._sidx(seq)
        if self.count[i, j] > 0:
            return float(self.mean[i, j])
        return float(self.analytic(bsz, seq))

    def lookup_batch(self, bsz: int, seqs: Sequence[int]) -> float:
        """Paper semantics: LUT[bsz, max seq in batch]."""
        return self.lookup(bsz, max(seqs) if len(seqs) else 1)

    # --------------------------------------------------------------- updates
    def update(self, bsz: int, seq: int, observed: float) -> None:
        """Running (historical) mean per cell — paper §3.2."""
        i, j = self._bidx(bsz), self._sidx(seq)
        c = self.count[i, j]
        self.mean[i, j] = (self.mean[i, j] * c + observed) / (c + 1)
        self.count[i, j] = c + 1

    # ------------------------------------------------------------ jax export
    def as_arrays(self):
        """(bsz_edges, seq_edges, table) for the jittable scheduler."""
        return (
            np.asarray(self.bsz_buckets, np.int32),
            np.asarray(self.seq_buckets, np.int32),
            self.mean.astype(np.float32),
        )

    # ---------------------------------------------------------- checkpointing
    def state_dict(self) -> dict:
        return dict(
            bsz_buckets=list(self.bsz_buckets),
            seq_buckets=list(self.seq_buckets),
            mean=self.mean.copy(),
            count=self.count.copy(),
        )

    def load_state_dict(self, st: dict) -> None:
        assert list(st["bsz_buckets"]) == self.bsz_buckets
        assert list(st["seq_buckets"]) == self.seq_buckets
        self.mean = np.array(st["mean"])
        self.count = np.array(st["count"])
