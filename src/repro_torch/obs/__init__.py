"""repro_torch.obs — unified per-request event tracing and SLO telemetry (a
copy of ``repro.obs``).

One typed event schema (`repro_torch.obs.events`) emitted by every serving
layer of the port — `ServeSession`, `AsyncServeSession`, `RouterSession`,
the `DisaggSession` fleet and the `FleetSession` controller — so a
request's lifecycle (submit → admit/shed → prefill → KV handoff → decode
steps → tokens → done/cancel) reads identically whichever layer served it,
and identically to the JAX package's stream. Exporters
(`repro_torch.obs.export`) turn the stream into JSONL or Chrome trace-event /
Perfetto JSON; `repro_torch.obs.slo` derives windowed TTFT/TPOT/e2e
attainment, queue-depth and in-flight-transfer gauges, and the per-step
decode-time-vs-TPOT-budget series — the signal the fleet controller's
autoscaler consumes.

Clock discipline: nothing in this package reads a clock. Every timestamp
is handed to `TraceRecorder.emit` by the emitting session, which only ever
passes values it already read from its injected `Clock` — so an enabled
recorder cannot perturb scheduling, and a disabled one (the default,
`trace=None`) costs nothing at all.
"""
from repro_torch.obs.events import (
    Event,
    EventType,
    TERMINAL_EVENTS,
    TraceRecorder,
    check_terminal_invariant,
    counters_from_events,
)
from repro_torch.obs.export import (
    chrome_trace,
    read_jsonl,
    write_chrome_trace,
    write_jsonl,
    write_trace,
)
from repro_torch.obs.slo import (
    attainment_from_events,
    per_request_timelines,
    trace_cell_block,
    windowed_slo,
)

__all__ = [
    "Event",
    "EventType",
    "TERMINAL_EVENTS",
    "TraceRecorder",
    "attainment_from_events",
    "check_terminal_invariant",
    "chrome_trace",
    "counters_from_events",
    "per_request_timelines",
    "read_jsonl",
    "trace_cell_block",
    "windowed_slo",
    "write_chrome_trace",
    "write_jsonl",
    "write_trace",
]
