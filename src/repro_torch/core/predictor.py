"""Prefill finish-time prediction (paper Algorithm 2) + throughput estimator.

The paper re-estimates every request's FCFS finish time at the start of each
prefill step, using a running estimate of prefill throughput (tokens/sec).
Its Algorithm 2 is O(n) per request => O(n^2) per step; we implement the
faithful form *and* an O(n) max-plus scan that returns all finish times at
once (the recurrence t_i = max(t_{i-1}, a_i) + d_i is a max-plus prefix
product) — results are identical (property-tested).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from repro_torch.core.request import Request


@dataclass
class PrefillThroughputEstimator:
    """Running estimate of prefill tokens/sec (paper: UPDATETHROUGHPUT).

    The paper maintains "a running estimate of the average prefill
    throughput"; we use an EWMA so the estimate tracks drift (prefix-cache
    hit-rate changes, power throttling) with bounded memory.
    """

    mu: float  # tokens per second
    alpha: float = 0.2  # EWMA weight for new observations
    _n: int = 0

    def update(self, tokens: int, elapsed: float) -> None:
        if elapsed <= 0 or tokens <= 0:
            return
        obs = tokens / elapsed
        if self._n == 0:
            self.mu = obs
        else:
            self.mu = (1 - self.alpha) * self.mu + self.alpha * obs
        self._n += 1


def predict_finish_time_fcfs(
    queue: Sequence[Request], target: Request, t_now: float, mu: float
) -> float:
    """Paper Algorithm 2, verbatim: simulated FCFS clock up to `target`."""
    cursor = t_now
    for r in sorted(queue, key=lambda r: (r.arrival, r.rid)):
        if r.arrival > target.arrival or (r.arrival == target.arrival and r.rid > target.rid):
            continue
        d = r.remaining_prefill_tokens / max(mu, 1e-9)
        cursor = max(cursor, r.arrival) + d
    return cursor


def predict_all_finish_times(
    queue: Sequence[Request], t_now: float, mu: float
) -> np.ndarray:
    """All FCFS finish times in one O(n log n) pass (max-plus scan).

    Returns finish times aligned with `queue` order (not arrival order).
    Identical to calling predict_finish_time_fcfs per request.
    """
    n = len(queue)
    if n == 0:
        return np.zeros(0)
    arrivals = np.array([r.arrival for r in queue])
    rids = np.array([r.rid for r in queue])
    durs = np.array([r.remaining_prefill_tokens / max(mu, 1e-9) for r in queue])
    order = np.lexsort((rids, arrivals))
    t = t_now
    finish_sorted = np.empty(n)
    for i, idx in enumerate(order):  # simple scan; O(n)
        t = max(t, arrivals[idx]) + durs[idx]
        finish_sorted[i] = t
    out = np.empty(n)
    out[order] = finish_sorted
    return out
