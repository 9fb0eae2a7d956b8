"""Typed per-request event stream of the serving session (a copy of
``repro.obs.events``; the exporters and SLO windows are not ported yet)."""
from repro_torch.obs.events import (
    TERMINAL_EVENTS,
    Event,
    EventType,
    TraceRecorder,
    check_terminal_invariant,
    counters_from_events,
)

__all__ = [
    "Event",
    "EventType",
    "TERMINAL_EVENTS",
    "TraceRecorder",
    "check_terminal_invariant",
    "counters_from_events",
]
