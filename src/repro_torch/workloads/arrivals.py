"""Arrival processes for workload scenarios (a copy of
``repro.workloads.arrivals``).

The paper evaluates under Poisson arrivals only; real traffic is bursty
(correlated on/off phases) and diurnal (rate follows a daily cycle). Each
process here maps ``(n, rng) -> n sorted arrival times`` and is a frozen
dataclass so scenarios embedding one stay hashable/serializable.

    PoissonArrivals           memoryless, constant rate (paper baseline)
    MarkovModulatedArrivals   2-state MMPP: exponential on/off phases with
                              distinct rates — long-range burstiness
    SinusoidalArrivals        non-homogeneous Poisson with a sinusoidal
                              rate (diurnal cycle), sampled by thinning
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class ArrivalProcess(Protocol):
    def times(self, n: int, rng: np.random.Generator) -> np.ndarray: ...


@dataclass(frozen=True)
class PoissonArrivals:
    """Homogeneous Poisson arrivals at a constant QPS."""

    qps: float = 3.0

    def __post_init__(self):
        if self.qps <= 0:
            raise ValueError(f"qps must be positive, got {self.qps}")

    def times(self, n: int, rng: np.random.Generator) -> np.ndarray:
        return np.cumsum(rng.exponential(1.0 / self.qps, size=n))


@dataclass(frozen=True)
class MarkovModulatedArrivals:
    """2-state Markov-modulated Poisson process (on/off bursts).

    The system alternates between an *on* phase (rate ``qps_on``) and an
    *off* phase (rate ``qps_off``), with exponentially distributed phase
    durations. Because both the phase process and the within-phase arrivals
    are memoryless, a gap that crosses a phase boundary is simply redrawn
    at the new rate from the boundary.
    """

    qps_on: float = 9.0
    qps_off: float = 0.6
    mean_on: float = 15.0  # expected seconds per on phase
    mean_off: float = 30.0

    def __post_init__(self):
        if self.qps_on <= 0:
            raise ValueError(f"qps_on must be positive, got {self.qps_on}")
        if self.qps_off < 0:
            raise ValueError(f"qps_off must be >= 0, got {self.qps_off}")
        if self.mean_on <= 0 or self.mean_off <= 0:
            raise ValueError("phase durations must be positive")

    def times(self, n: int, rng: np.random.Generator) -> np.ndarray:
        out = np.empty(n)
        # start in the stationary phase distribution
        on = bool(rng.random() < self.mean_on / (self.mean_on + self.mean_off))
        t = 0.0
        t_switch = rng.exponential(self.mean_on if on else self.mean_off)
        i = 0
        while i < n:
            rate = self.qps_on if on else self.qps_off
            gap = rng.exponential(1.0 / rate) if rate > 0 else np.inf
            if t + gap >= t_switch:
                t = t_switch
                on = not on
                t_switch = t + rng.exponential(self.mean_on if on else self.mean_off)
                continue
            t += gap
            out[i] = t
            i += 1
        return out


@dataclass(frozen=True)
class SinusoidalArrivals:
    """Diurnal arrivals: rate(t) = qps_mean * (1 + amplitude*sin(2πt/period)).

    Sampled exactly by thinning (Lewis & Shedler): candidates at the peak
    rate, accepted with probability rate(t)/peak.
    """

    qps_mean: float = 3.0
    amplitude: float = 0.8  # relative swing, in [0, 1)
    period: float = 240.0  # seconds per cycle

    def __post_init__(self):
        if self.qps_mean <= 0:
            raise ValueError(f"qps_mean must be positive, got {self.qps_mean}")
        if not 0.0 <= self.amplitude < 1.0:
            raise ValueError(f"amplitude must be in [0, 1), got {self.amplitude}")
        if self.period <= 0:
            raise ValueError(f"period must be positive, got {self.period}")

    def rate(self, t: float) -> float:
        return self.qps_mean * (1.0 + self.amplitude * np.sin(2.0 * np.pi * t / self.period))

    def times(self, n: int, rng: np.random.Generator) -> np.ndarray:
        peak = self.qps_mean * (1.0 + self.amplitude)
        out = np.empty(n)
        t = 0.0
        i = 0
        while i < n:
            t += rng.exponential(1.0 / peak)
            if rng.random() * peak <= self.rate(t):
                out[i] = t
                i += 1
        return out
