"""The one traffic generator: reads a mix's parameters (a JSON file beside
this one) and draws its requests.

The length mixture and the Poisson gaps are frozen copies of the port's
``sim.trace.LengthDist.sample`` and ``workloads.arrivals.PoissonArrivals``
(the paper's Fig. 1a lengths), without the port's rescaling to toy sizes.

Every seed gets the same work in another order: the lengths and the gaps
are drawn once from the mix's ``pool_seed``, and ``--seed`` only permutes
them (lengths and gaps apart) and draws the prompt tokens. So two seeds
differ in which request comes when, not in how much there is to do.

Open loop (``"loop": "open"``): ``rate`` requests a second in two
segments, the lead-in (``lead_in_s`` seconds before the measured window)
and the window, each with its own ``round(rate * length)`` requests. The
pool's first lengths go to the lead-in and the rest to the window, and each
segment's arrivals are a Poisson process held to that count: its gaps,
permuted within the segment, are scaled to span it, the last one running
to the segment's end. So every seed sends the window the same requests, as
many of them, and the same gaps, in another order.
With ``"order": "fixed"`` the seed permutes nothing: every seed sends the
pool's requests in the pool's order, and draws only the prompt tokens.
Closed loop (``"loop": "closed"``): ``clients`` clients, each sending its
next request when its last one completes; requests are handed out in
order, ``requests_per_client`` a client (default ``pool_per_client``), the
pool's lengths cycling in their permuted order, every request with prompt
tokens of its own (a repeated prompt would hit the prefix cache). A pool of
about as many requests as the window takes gives every seed's window
nearly the same lengths.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

# the port's LengthDist defaults: the paper's long-tail mixture
LENGTH_DEFAULTS = dict(
    long_frac=0.08, short_median=1800.0, short_sigma=0.75, long_median=24000.0,
    long_sigma=0.95, min_input=64, max_input=131_072, out_median_short=220.0,
    out_median_long=300.0, out_sigma=0.9, min_output=8, max_output=4000,
)


def sample_lengths(n: int, rng: np.random.Generator, **kw) -> Tuple[np.ndarray, np.ndarray]:
    """(input_lens, output_lens) of ``n`` requests: the port's
    ``LengthDist.sample``, draw for draw."""
    p = {**LENGTH_DEFAULTS, **kw}
    is_long = rng.random(n) < p["long_frac"]
    ln_short = rng.lognormal(np.log(p["short_median"]), p["short_sigma"], size=n)
    ln_long = rng.lognormal(np.log(p["long_median"]), p["long_sigma"], size=n)
    inputs = np.where(is_long, ln_long, ln_short)
    inputs = np.clip(inputs, p["min_input"], p["max_input"]).astype(int)
    out_med = np.where(is_long, p["out_median_long"], p["out_median_short"])
    outputs = rng.lognormal(np.log(out_med), p["out_sigma"])
    outputs = np.clip(outputs, p["min_output"], p["max_output"]).astype(int)
    return inputs, outputs


def poisson_times(n: int, rate: float, rng: np.random.Generator) -> np.ndarray:
    """The port's ``PoissonArrivals(rate).times(n, rng)``."""
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def clip_to_context(inp: int, out: int, max_len: int) -> Tuple[int, int]:
    """Fit a request into a context of ``max_len``: the output to at most
    half of it, then the prompt so that prompt + output <= max_len - 1
    (the engine ends a request at max_len - 1)."""
    out = min(out, max_len // 2)
    return min(inp, max_len - 1 - out), out


@dataclass
class Req:
    """One request as the benchmark sends it."""

    idx: int
    due: float  # seconds from the session's start; closed loop: set when sent
    input_len: int
    output_len: int
    prompt: List[int] = field(repr=False, default_factory=list)
    clipped: bool = False


@dataclass
class Mix:
    name: str
    params: Dict

    @classmethod
    def load(cls, path: Path) -> "Mix":
        return cls(path.stem, json.loads(path.read_text()))

    @property
    def loop(self) -> str:
        return self.params["loop"]

    @property
    def lead_in_s(self) -> float:
        return float(self.params["lead_in_s"])

    @property
    def slo(self) -> Tuple[float, float]:
        s = self.params["slo"]
        return float(s["ttft_s"]), float(s["tpot_s"])

    def segments(self, seconds: float) -> List[Tuple[float, float, int]]:
        """Open loop: (start, end, requests) of the lead-in and the window."""
        rate, lead = float(self.params["rate"]), self.lead_in_s
        return [(0.0, lead, int(round(rate * lead))),
                (lead, lead + seconds, max(1, int(round(rate * seconds))))]

    def pool_size(self, seconds: float) -> int:
        if self.loop == "open":
            return sum(m for _, _, m in self.segments(seconds))
        return int(self.params["clients"] * self.params["pool_per_client"])

    def n_requests(self, seconds: float) -> int:
        if self.loop == "open":
            return self.pool_size(seconds)
        per = self.params.get("requests_per_client", self.params["pool_per_client"])
        return int(self.params["clients"] * per)

    def _perm(self, rng: np.random.Generator, n: int) -> np.ndarray:
        fixed = self.params.get("order", "permuted") == "fixed"
        return np.arange(n) if fixed else rng.permutation(n)

    def draw(self, seed: int, seconds: float, max_len: int, vocab: int) -> List[Req]:
        """The run's requests: the pool's lengths (and gaps) permuted by
        ``seed`` (unless the order is fixed), prompts drawn from ``seed``
        over token ids 2 .. vocab - 1 (0 pads, 1 ends a sequence)."""
        n = self.pool_size(seconds)
        pool = np.random.default_rng(int(self.params["pool_seed"]))
        inputs, outputs = sample_lengths(n, pool, **self.params.get("lengths", {}))
        rng = np.random.default_rng(seed)
        if self.loop == "open":
            segs = self.segments(seconds)
            # one gap more than requests in each segment: the last runs to its end
            gaps = np.diff(poisson_times(n + len(segs), float(self.params["rate"]), pool),
                           prepend=0.0)
            order, dues, first, g0 = [], [], 0, 0
            for a, b, m in segs:
                g = gaps[g0:g0 + m + 1][self._perm(rng, m + 1)]
                order.extend(first + self._perm(rng, m))
                dues.extend(a + (b - a) * np.cumsum(g)[:m] / g.sum())
                first, g0 = first + m, g0 + m + 1
        else:
            order = self._perm(rng, n)
            dues = np.zeros(self.n_requests(seconds))
        reqs = []
        for i in range(len(dues)):
            inp, out = int(inputs[order[i % n]]), int(outputs[order[i % n]])
            ci, co = clip_to_context(inp, out, max_len)
            reqs.append(Req(i, float(dues[i]), ci, co, clipped=(ci, co) != (inp, out)))
        tokens = rng.integers(2, vocab, size=sum(r.input_len for r in reqs))
        off = 0
        for r in reqs:
            r.prompt = tokens[off:off + r.input_len].tolist()
            off += r.input_len
        return reqs
