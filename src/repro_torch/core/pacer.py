"""Token delivery pacer (a copy of ``repro.core.pacer``).

Kairos decodes short requests ahead of their TPOT deadline and banks the
excess tokens ("the excess tokens can be buffered and released gradually,
effectively decoupling generation speed from token delivery", paper §2.3).
The pacer converts generation timestamps into client delivery timestamps.

Modes:
  immediate — deliver as generated (metric-neutral; default for evaluation)
  paced     — release at the TPOT cadence: token n is delivered at
              max(gen_time_n, first_token + n * TPOT_pace) with pace <= SLO.
              Smooth UX; still meets TPOT because pace <= SLO.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence


@dataclass
class DeliveryPacer:
    mode: str = "immediate"  # immediate | paced
    pace_fraction: float = 0.9  # paced: release at 90% of the SLO interval

    def delivery_times(
        self, gen_times: Sequence[float], first_token_time: float, tpot_slo: float
    ) -> List[float]:
        if self.mode == "immediate" or not gen_times:
            return list(gen_times)
        pace = tpot_slo * self.pace_fraction
        out: List[float] = []
        prev = first_token_time
        for n, t in enumerate(gen_times):
            if n == 0:
                d = t  # first token defines the TTFT; never delayed
            else:
                d = max(t, prev + 0.0, first_token_time + n * pace)
                d = max(d, prev)  # monotone
            out.append(d)
            prev = d
        return out

    def banked(self, gen_times: Sequence[float], t_now: float, first_token_time: float, tpot_slo: float) -> int:
        """How many generated-but-undelivered tokens are in the bank at t_now."""
        deliv = self.delivery_times(gen_times, first_token_time, tpot_slo)
        gen_done = sum(1 for t in gen_times if t <= t_now)
        delivered = sum(1 for t in deliv if t <= t_now)
        return gen_done - delivered
