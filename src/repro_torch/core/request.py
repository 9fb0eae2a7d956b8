"""Request model: lifecycle state shared by the simulator and the engine."""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass(frozen=True)
class SLOSpec:
    """Service-level objectives. Paper defaults: TTFT 8 s, TPOT 50 ms."""

    ttft: float = 8.0
    tpot: float = 0.050


class Phase(enum.Enum):
    QUEUED = "queued"  # waiting for prefill
    PREFILL = "prefill"  # chunked prefill in progress
    TRANSFER = "transfer"  # KV moving prefill -> decode instance
    DECODE = "decode"  # active on the decode instance
    DONE = "done"
    FAILED = "failed"  # shed by admission control (an SLO miss)
    CANCELLED = "cancelled"  # client disconnected / withdrew the request


# Terminal phases: the request will never produce another token. CANCELLED is
# deliberately distinct from FAILED — a shed request is the *server's* SLO
# miss, a cancelled one is the *client* walking away (metrics must not
# conflate them; see sim/metrics.attainment).
TERMINAL_PHASES = frozenset({Phase.DONE, Phase.FAILED, Phase.CANCELLED})


@dataclass
class Request:
    rid: int
    arrival: float
    input_len: int
    # sim: the true output length; engine: max new tokens
    output_len: int
    slo: SLOSpec = field(default_factory=SLOSpec)
    # multi-tenant serving: who submitted this and which SLO tier it bought.
    # `slo` holds the resolved numeric targets; `slo_class` is the named tier
    # (metrics group by it, admission quotas group by `tenant`).
    tenant: str = "default"
    slo_class: str = "standard"
    # prefix sharing: requests carrying the same non-empty `prefix_group`
    # begin with one shared prompt template covering `prefix_frac` of
    # input_len (the "shared system prompt" shape prefix-aware routing
    # exploits); the sim ignores both, the engine harness materializes them
    prefix_group: str = ""
    prefix_frac: float = 0.0

    # --- dynamic state ---------------------------------------------------
    phase: Phase = Phase.QUEUED
    prefilled_tokens: int = 0  # chunked-prefill progress
    prefix_cached_tokens: int = 0  # prefix-cache hits reduce remaining work
    # tokens matched in the session's PrefixCache at admission — pure KV
    # budget/metrics accounting, unlike prefix_cached_tokens it never skips
    # compute (token outputs stay invariant to the cache)
    prefix_hit_tokens: int = 0
    prefill_finish: Optional[float] = None
    first_token_time: Optional[float] = None  # == prefill_finish in PD disagg
    decode_start: Optional[float] = None  # admission to the decode instance
    n_generated: int = 0
    n_decoded: int = 0  # tokens produced by the decode instance (excl. prefill's)
    token_times: List[float] = field(default_factory=list)  # generation times
    delivery_times: List[float] = field(default_factory=list)  # after pacing
    done_time: Optional[float] = None
    restarts: int = 0  # fault-tolerance: times this request was re-prefilled

    # ---------------------------------------------------------------- props
    @property
    def seq_len(self) -> int:
        """Current total sequence length (prompt + generated)."""
        return self.input_len + self.n_generated

    @property
    def remaining_prefill_tokens(self) -> int:
        return max(0, self.input_len - self.prefix_cached_tokens - self.prefilled_tokens)

    @property
    def prefill_done(self) -> bool:
        return self.remaining_prefill_tokens == 0

    @property
    def decode_done(self) -> bool:
        return self.n_generated >= self.output_len

    # --------------------------------------------------------------- events
    def reset_for_restart(self) -> None:
        """Node failure: KV lost; request re-enters the prefill queue.

        Generated tokens already delivered are kept (the client has them);
        prefill must redo the prompt + regenerated context.
        """
        self.phase = Phase.QUEUED
        self.prefilled_tokens = 0
        self.prefill_finish = None
        self.decode_start = None
        self.n_decoded = 0
        self.restarts += 1

    # --------------------------------------------------------------- metrics
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival

    def mean_tpot(self) -> Optional[float]:
        """Mean inter-token latency over generated tokens (paper metric)."""
        if self.first_token_time is None or self.n_generated <= 1:
            return 0.0 if self.first_token_time is not None else None
        times = self.delivery_times if self.delivery_times else self.token_times
        if len(times) < 2:
            return 0.0
        return (times[-1] - times[0]) / (len(times) - 1)

    def decode_tput(self) -> Optional[float]:
        """Per-request decode speed in tokens/sec (paper Fig. 6 metric)."""
        if self.done_time is None or self.first_token_time is None:
            return None
        dur = self.done_time - self.first_token_time
        if dur <= 0:
            return None
        return self.n_generated / dur

    def meets_ttft(self) -> bool:
        t = self.ttft()
        return t is not None and t <= self.slo.ttft

    def meets_tpot(self) -> bool:
        t = self.mean_tpot()
        return t is not None and t <= self.slo.tpot

    def meets_e2e(self) -> bool:
        return self.meets_ttft() and self.meets_tpot()
