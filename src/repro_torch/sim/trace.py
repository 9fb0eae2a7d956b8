"""Long-tail request trace generation + loading (a copy of
``repro.sim.trace``).

The paper evaluates on a production trace of 1000 requests with a pronounced
long-tail length distribution (Fig. 1a). We generate a statistically similar
trace: a lognormal body of short requests plus a lognormal long tail, Poisson
arrivals at a target QPS. `load_trace` accepts external JSONL traces
({"arrival":…,"input_len":…,"output_len":…} per line) for replaying real
production data.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, fields
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.request import Request, SLOSpec


@dataclass(frozen=True)
class LengthDist:
    """Lognormal body + lognormal long-tail length mixture (paper Fig. 1a).

    The one source of truth for the paper's length distribution: both
    `generate_trace` (via `TraceConfig.lengths()`) and the per-tenant
    `repro_torch.workloads` scenarios sample through this class, so the defaults
    here ARE the `TraceConfig` defaults.
    """

    # input lengths: mixture of lognormal body + lognormal long tail
    long_frac: float = 0.08
    short_median: float = 1800.0
    short_sigma: float = 0.75
    long_median: float = 24000.0
    long_sigma: float = 0.95
    min_input: int = 64
    max_input: int = 131_072  # paper's examples top out at 128K

    # output lengths
    out_median_short: float = 220.0
    out_median_long: float = 300.0
    out_sigma: float = 0.9
    min_output: int = 8
    max_output: int = 4000

    def sample(self, n: int, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        """Draw (input_lens, output_lens) for n requests."""
        is_long = rng.random(n) < self.long_frac
        ln_short = rng.lognormal(np.log(self.short_median), self.short_sigma, size=n)
        ln_long = rng.lognormal(np.log(self.long_median), self.long_sigma, size=n)
        input_lens = np.where(is_long, ln_long, ln_short)
        input_lens = np.clip(input_lens, self.min_input, self.max_input).astype(int)
        out_med = np.where(is_long, self.out_median_long, self.out_median_short)
        output_lens = rng.lognormal(np.log(out_med), self.out_sigma)
        output_lens = np.clip(output_lens, self.min_output, self.max_output).astype(int)
        return input_lens, output_lens


@dataclass(frozen=True)
class TraceConfig(LengthDist):
    n_requests: int = 1000
    qps: float = 3.0
    seed: int = 0

    # SLOs (paper §4.1)
    slo_ttft: float = 8.0
    slo_tpot: float = 0.050

    def lengths(self) -> LengthDist:
        return LengthDist(**{f.name: getattr(self, f.name) for f in fields(LengthDist)})


def generate_trace(cfg: TraceConfig) -> List[Request]:
    rng = np.random.default_rng(cfg.seed)
    n = cfg.n_requests
    gaps = rng.exponential(1.0 / cfg.qps, size=n)
    arrivals = np.cumsum(gaps)
    input_lens, output_lens = cfg.lengths().sample(n, rng)
    slo = SLOSpec(ttft=cfg.slo_ttft, tpot=cfg.slo_tpot)
    return [
        Request(
            rid=i,
            arrival=float(arrivals[i]),
            input_len=int(input_lens[i]),
            output_len=int(output_lens[i]),
            slo=slo,
        )
        for i in range(n)
    ]


def _parse_trace_line(path: str, lineno: int, line: str) -> dict:
    try:
        row = json.loads(line)
    except json.JSONDecodeError as e:
        raise ValueError(f"{path}:{lineno}: malformed trace line (not valid JSON): {e}") from None
    if not isinstance(row, dict):
        raise ValueError(
            f"{path}:{lineno}: trace line must be a JSON object, got {type(row).__name__}"
        )
    missing = [k for k in ("input_len", "output_len") if k not in row]
    if missing:
        raise ValueError(
            f"{path}:{lineno}: trace line missing required field(s) {missing}; "
            f'expected {{"arrival":…,"input_len":…,"output_len":…}} per line'
        )
    for k in ("input_len", "output_len"):
        v = row[k]
        # accept JSON integers only (12.0 is fine, 12.9 would silently
        # truncate, "12" hints at a mis-serialized trace)
        if (
            isinstance(v, bool)
            or not isinstance(v, (int, float))
            or (isinstance(v, float) and not v.is_integer())
        ):
            raise ValueError(
                f"{path}:{lineno}: field {k!r} must be an integer, got {v!r}"
            )
        row[k] = int(v)
        if row[k] <= 0:
            raise ValueError(f"{path}:{lineno}: field {k!r} must be positive, got {row[k]}")
    for k in ("arrival", "slo_ttft", "slo_tpot"):
        if k in row:
            v = row[k]
            # JSON numbers only; reject NaN/Infinity (json.loads accepts the
            # literals, and NaN poisons arrival sorting + qps rescaling)
            if isinstance(v, bool) or not isinstance(v, (int, float)) or not math.isfinite(v):
                raise ValueError(
                    f"{path}:{lineno}: field {k!r} must be a finite number, got {v!r}"
                )
            row[k] = float(v)
            if row[k] < 0:
                raise ValueError(
                    f"{path}:{lineno}: field {k!r} must be >= 0, got {row[k]}"
                )
    return row


def load_trace(path: str, qps: Optional[float] = None, slo: Optional[SLOSpec] = None) -> List[Request]:
    """Load a JSONL trace; optionally rescale arrivals to a target QPS.

    Per-line fields: required ``input_len``/``output_len``; optional
    ``arrival``, ``tenant``, ``slo_class``, ``slo_ttft``/``slo_tpot`` (which
    override the ``slo`` default). Malformed lines raise ``ValueError``
    naming the file and line number.
    """
    if slo is None:
        slo = SLOSpec()
    rows = []
    with open(path) as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if line:
                rows.append(_parse_trace_line(path, lineno, line))
    reqs = [
        Request(
            rid=i,
            arrival=float(r.get("arrival", i)),
            input_len=r["input_len"],
            output_len=r["output_len"],
            slo=SLOSpec(
                ttft=float(r.get("slo_ttft", slo.ttft)),
                tpot=float(r.get("slo_tpot", slo.tpot)),
            ),
            tenant=str(r.get("tenant", "default")),
            slo_class=str(r.get("slo_class", "standard")),
        )
        for i, r in enumerate(rows)
    ]
    if qps is not None:
        rescale_qps(reqs, qps)
    return reqs


def rescale_qps(reqs: List[Request], qps: float) -> List[Request]:
    """Rescale arrivals in place so the trace averages ``qps``; arrivals are
    re-zeroed to the first one. Returns the same list for chaining."""
    if reqs:
        span = max(r.arrival for r in reqs) - min(r.arrival for r in reqs)
        target_span = len(reqs) / qps
        scale = target_span / max(span, 1e-9)
        t0 = min(r.arrival for r in reqs)
        for r in reqs:
            r.arrival = (r.arrival - t0) * scale
    return reqs


def save_trace(path: str, requests: List[Request]) -> None:
    """Write requests as a JSONL trace (inverse of `load_trace`).

    Round-trip preserving: arrival, lengths, tenant, slo_class, and the
    numeric SLO targets. `load_trace(save_trace(path, reqs))` rebuilds an
    equivalent trace (rids are reassigned by position).
    """
    with open(path, "w") as f:
        for r in requests:
            f.write(
                json.dumps(
                    dict(
                        arrival=float(r.arrival),
                        input_len=int(r.input_len),
                        output_len=int(r.output_len),
                        tenant=r.tenant,
                        slo_class=r.slo_class,
                        slo_ttft=float(r.slo.ttft),
                        slo_tpot=float(r.slo.tpot),
                    )
                )
                + "\n"
            )


def trace_stats(reqs: List[Request]) -> dict:
    ins = np.array([r.input_len for r in reqs])
    outs = np.array([r.output_len for r in reqs])
    return dict(
        n=len(reqs),
        input_p50=float(np.percentile(ins, 50)),
        input_p90=float(np.percentile(ins, 90)),
        input_p99=float(np.percentile(ins, 99)),
        input_max=int(ins.max()),
        input_mean=float(ins.mean()),
        output_p50=float(np.percentile(outs, 50)),
        output_p99=float(np.percentile(outs, 99)),
        output_mean=float(outs.mean()),
    )
