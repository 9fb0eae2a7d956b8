"""Decode-side policies: Kairos slack-guided adaptive batching (paper
Algorithm 3) + the continuous-batching baseline (DistServe).

Each decode step the policy partitions the active set D into a batch B to
execute now and a delayed set R_delay that idles this step. Kairos packs
short requests whenever every active request still has enough TPOT slack.

Three registered names, two classes: ``kairos-slack-greedy`` is the
beyond-paper greedy-fill variant of ``SlackDecodeScheduler`` (see the
``require_throughput_gain`` note below), registered with different
construction defaults. Both backends construct these via ``make_decode`` —
see ``repro_torch.policies.registry``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from repro_torch.core.lut import StepTimeLUT
from repro_torch.core.request import Request
from repro_torch.policies.registry import Partition, register_decode


@register_decode("kairos-slack")
@dataclass
class SlackDecodeScheduler:
    """Paper Algorithm 3: slack-guided adaptive decode scheduling.

    Two production refinements over the printed formulas (both default-on,
    disable for the verbatim paper semantics; see DESIGN.md §5):

    * `slo_margin`: schedule against margin*TPOT. Eq. 2 paces delayed
      requests at *exactly* the SLO boundary, so any jitter (admission gap,
      LUT error, step granularity) tips their mean ITL just over target; a
      ~10% margin absorbs it.
    * *actionable slack*: Eq. 2 measures elapsed from the prefill-emitted
      first token, so time spent in KV transfer + admission queueing becomes
      unrecoverable "debt" that drives s_min permanently negative and
      disables packing for the whole batch. We instead pace each request's
      decode-side tokens against its decode admission time
      (`Request.decode_start`); the metric still measures the true TTFT/TPOT
      including the gap — the margin covers the amortized gap.
    """

    lut: StepTimeLUT
    name: str = "kairos-slack"
    slo_margin: float = 0.9
    actionable_slack: bool = True

    def slack(self, r: Request, t_now: float) -> float:
        """Eq. 2: remaining budget before the next token must be delivered."""
        assert r.first_token_time is not None
        if self.actionable_slack and r.decode_start is not None:
            base, n = r.decode_start, r.n_decoded
        else:
            base, n = r.first_token_time, r.n_generated
        elapsed = t_now - base
        return (
            r.slo.tpot * self.slo_margin * (n + 1)
            - elapsed
            - self.lut.lookup(1, r.seq_len)
        )

    # require_throughput_gain=True is the paper's Alg. 3 line 13 condition.
    # False ("greedy-fill", beyond-paper, registered as kairos-slack-greedy)
    # admits any request that still fits the s_min budget: mid-length
    # requests are no longer pinned to the SLO pace when capacity allows, at
    # a small cost in short-request latency.
    require_throughput_gain: bool = True

    def select(self, active: Sequence[Request], t_now: float) -> Partition:
        if not active:
            return [], []
        slacks = np.array([self.slack(r, t_now) for r in active])
        s_min = float(np.min(slacks))

        # ascending seq_len (rid tiebreak)
        order = sorted(range(len(active)), key=lambda i: (active[i].seq_len, active[i].rid))
        batch: List[Request] = []
        delayed: List[Request] = []
        t_cur = 0.0
        for i in order:
            r = active[i]
            t_step = self.lut.lookup(len(batch) + 1, r.seq_len)
            improves = (
                (not batch)
                or not self.require_throughput_gain
                or (len(batch) + 1) / t_step > len(batch) / t_cur
            )
            if t_step <= s_min and improves:
                batch.append(r)
                t_cur = t_step
            else:
                delayed.append(r)
        if not batch:  # no slack to exploit; decode everything (Alg. 3 l.19-21)
            return list(active), []
        return batch, delayed

    def observe(self, batch: Sequence[Request], actual: float) -> None:
        """Post-step LUT update (Alg. 3 lines 23-24)."""
        if not batch:
            return
        self.lut.update(len(batch), max(r.seq_len for r in batch), actual)


@register_decode("continuous")
@dataclass
class ContinuousBatchingScheduler:
    """DistServe baseline: decode every active request each step."""

    lut: StepTimeLUT
    name: str = "continuous"

    def select(self, active: Sequence[Request], t_now: float) -> Partition:
        return list(active), []

    def observe(self, batch: Sequence[Request], actual: float) -> None:
        if batch:
            self.lut.update(len(batch), max(r.seq_len for r in batch), actual)


# Beyond-paper greedy-fill variant: same class, different construction
# defaults. The registry stamps instances with the registered name.
register_decode("kairos-slack-greedy", require_throughput_gain=False)(
    SlackDecodeScheduler
)
