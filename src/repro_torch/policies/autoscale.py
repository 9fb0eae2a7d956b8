"""Autoscaler policies: how many replicas should the fleet be running? (A copy
of ``repro.policies.autoscale``.)

The fifth registry side. An `AutoscalerPolicy` consumes `repro_torch.obs.slo.
windowed_slo` output — per-window attainment fractions, queue-depth and
in-flight-transfer gauges, decode-time-vs-TPOT-budget series — and returns
the desired live-replica count. Deliberately *telemetry-driven*: the
controller (`repro_torch.serving.fleetctl.AutoscaleController`) hands policies the
same windowed series an operator's dashboard would show, never session
internals, so a policy that works here works against any backend that emits
the unified event stream (DESIGN.md §obs).

Decisions are clamped to ``[n_min, n_max]`` by the controller and applied at
most one replica per control interval (scale thrash is worse than a slow
ramp); policies therefore return a *target*, not a delta. All three built-ins
are deterministic functions of the telemetry (the PID variant keeps an
integral accumulator — stateful like the decode schedulers' ``observe``, but
still replayable bit-for-bit on a `ManualClock`).

Registered under `@register_autoscaler`; `make_autoscaler("queue-threshold")`
builds them anywhere a name works.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Mapping, Optional

from repro_torch.policies.registry import register_autoscaler


def _windows(slo: Mapping[str, Any]) -> List[Mapping[str, Any]]:
    return list(slo.get("windows") or [])


@register_autoscaler("static")
@dataclass
class StaticAutoscaler:
    """Never scales: the fixed-fleet baseline every reactive policy must
    beat on SLO attainment under churn. ``n`` pins an explicit size;
    the default (None) holds whatever the fleet currently runs."""

    name: str = "static"
    n: Optional[int] = None

    def decide(self, slo: Mapping[str, Any], n_replicas: int,
               n_min: int, n_max: int) -> int:
        return n_replicas if self.n is None else self.n


@register_autoscaler("queue-threshold")
@dataclass
class QueueThresholdAutoscaler:
    """Classic watermark rule on the admission-queue gauge: grow while the
    latest window's peak queue depth sits at or above ``high``, shrink only
    once the queue has fully drained (peak at or below ``low`` *and* empty at
    the window edge) for ``cool_windows`` consecutive windows. The queue
    gauge leads attainment by a full window — a flash crowd shows up as
    standing queue before a single SLO miss is scored — which is exactly why
    this beats waiting for attainment to dip."""

    name: str = "queue-threshold"
    high: int = 4
    low: int = 0
    cool_windows: int = 2

    def decide(self, slo: Mapping[str, Any], n_replicas: int,
               n_min: int, n_max: int) -> int:
        windows = _windows(slo)
        if not windows:
            return n_replicas
        last = windows[-1]
        if last["queue_depth_max"] >= self.high:
            return n_replicas + 1
        tail = windows[-self.cool_windows:]
        drained = len(tail) >= self.cool_windows and all(
            w["queue_depth_max"] <= self.low and w["queue_depth_last"] == 0
            for w in tail
        )
        if drained:
            return n_replicas - 1
        return n_replicas


@register_autoscaler("slo-attainment-pid")
@dataclass
class SLOAttainmentPIDAutoscaler:
    """P+I control on the windowed e2e attainment deficit: error is
    ``target - e2e`` over the most recent scored window (windows with no
    terminals are skipped — an empty window is no evidence either way), the
    integral accumulates it with anti-windup at ``i_clamp``, and the fleet
    grows when the control signal crosses ``up`` or shrinks below ``down``.
    Attainment *lags* the queue gauge (a request scores only at its
    terminal), so this is the smoother, slower sibling of queue-threshold —
    the comparison the churn harness exists to measure."""

    name: str = "slo-attainment-pid"
    target: float = 0.95
    kp: float = 4.0
    ki: float = 1.0
    up: float = 0.5
    down: float = -0.5
    i_clamp: float = 2.0
    _integral: float = field(default=0.0, repr=False)

    def decide(self, slo: Mapping[str, Any], n_replicas: int,
               n_min: int, n_max: int) -> int:
        scored = [w for w in _windows(slo) if (w["done"] + w["shed"]) > 0]
        if not scored:
            return n_replicas
        err = self.target - scored[-1]["e2e"]
        self._integral = max(-self.i_clamp, min(self.i_clamp, self._integral + err))
        signal = self.kp * err + self.ki * self._integral
        if signal > self.up:
            return n_replicas + 1
        if signal < self.down:
            return n_replicas - 1
        return n_replicas
