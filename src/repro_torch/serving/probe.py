"""Span readings inside the engine's calls, into `TraceRecorder.spans`.

A session that holds a recorder keeps a `Probe` for each of its servers and
lends it to the server's engines for the length of one ``step()`` (`lent`),
taking it back when the step returns or raises, so a probe never outlives
the session's use of the server. An engine without one marks its phases on
`OFF`, which does nothing. At each phase boundary a probe

- reads the server's clock with ``peek()`` (`DisaggServer.peek_now`), which
  never charges a `ManualClock.auto_step`: a run on a virtual clock
  schedules the same with spans recorded or not;
- records a `torch.cuda.Event` on the current stream where the server's
  device is a card (the probe reuses its events from call to call);
- while a `torch.profiler` runs, closes the last phase's
  ``record_function`` range and opens the next one's, so the device
  trace's idle gaps can be put down to the phases.

Device times are read in `Phases.end`, after the call's own blocking copy
or synchronize, so a probe adds no sync; that reading, and the handing in
of the spans, lies inside the call's last span, so the spans tile the call
to its end. A phase's device time is the stream's time between its
boundary events: its kernels, and any wait of the stream for their
launches. A call that raises hands in nothing: its open range is closed
when its session step lets go of the probe, or at the next call.

The spans (name: where it is taken; ``data``):

    decode.gather   `DecodeEngine.step` from its entry: the token, position
                    and page-table tensors to the card, the gather of the
                    bucket's lanes
    decode.forward  `transformer.decode_step`
    decode.scatter  the scatter of the lanes back
    decode.sample   `sample` launched
    decode.wait     the blocking copy of the tokens to the host (host time
                    only; the step's last span ends after it)
    prefill.chunk   `PrefillEngine.run_chunk`, from seeding the cache to
                    the final copy or sync (rid, start, take)

`repro_torch.obs.export` lays them on each pool's ``engine`` thread of
the Chrome trace (``launch/loadgen.py --trace t.json``, ``launch/evaluate.py
--trace``), beside the requests' slices.

The MoE layer's ``moe.*`` ranges (`repro_torch.models.moe`) are profiler
ranges only: no clock is read and no span recorded for them.
"""
from __future__ import annotations

import contextlib
from typing import TYPE_CHECKING, Any, Iterator, List, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

if TYPE_CHECKING:  # annotations only
    from repro_torch.obs.events import TraceRecorder
    from repro_torch.serving.engine import DisaggServer


class Probe:
    """Takes the span readings of one server's engine calls for one
    session: ``pool`` is the session's label for the server."""

    def __init__(self, server: "DisaggServer", trace: "TraceRecorder", pool: str):
        self.server, self.trace, self.pool = server, trace, pool
        self.cuda = server.device.type == "cuda"
        self._free: List[torch.cuda.Event] = []  # events whose times were read
        self._live: Optional[Phases] = None  # the engine call under way

    def phases(self) -> "Phases":
        """The phases of one engine call."""
        self.drop()
        self._live = Phases(self, torch.autograd._profiler_enabled())
        return self._live

    def drop(self) -> None:
        """Forget the phases of a call that raised, closing its open range."""
        ph, self._live = self._live, None
        if ph is not None:
            ph.drop()

    def event(self) -> Optional[torch.cuda.Event]:
        if not self.cuda:
            return None
        ev = self._free.pop() if self._free else torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev


class Phases:
    """One engine call's phases, in order; each becomes a span at `end`."""

    __slots__ = ("_probe", "_ranges", "_open", "_range", "_done")

    def __init__(self, probe: Probe, ranges: bool):
        self._probe = probe
        self._ranges = ranges  # a profiler runs: open a range per phase
        self._open: Optional[list] = None  # [name, t0, start event, end event, data]
        self._range = None
        self._done: List[Tuple] = []

    def next(self, name: str, device: bool = True, **data: Any) -> None:
        """End the open phase and begin ``name``; ``device``: its time on
        the stream is read too."""
        p = self._probe
        t = p.server.peek_now()
        self._close(t)
        self._open = [name, t, p.event() if device else None, None, data]
        if self._ranges:
            self._range = record_function(name)
            self._range.__enter__()

    def fence(self) -> None:
        """The open phase's device work ends here; its host time runs on to
        the next boundary (a blocking copy or sync comes between)."""
        s = self._open
        if s[2] is not None and s[3] is None:
            s[3] = self._probe.event()

    def _close(self, t: float) -> None:
        s = self._open
        if s is None:
            return
        self.fence()
        self._done.append((s[0], s[1], t, s[2], s[3], s[4]))
        self.drop()

    def end(self) -> None:
        """Hand every span to the recorder. Called after the call's blocking
        copy or sync, so every event has been reached; the last phase is
        closed after the readings, which it therefore holds."""
        p = self._probe
        self.fence()
        for name, t0, t1, e0, e1, data in self._done:
            p.trace.span(name, t0, t1, device_s=self._read(e0, e1), pool=p.pool, **data)
        name, t0, e0, e1, data = self._open
        dev = self._read(e0, e1)
        self.drop()
        p.trace.span(name, t0, p.server.peek_now(), device_s=dev, pool=p.pool, **data)
        p._live = None

    def drop(self) -> None:
        """Close the open range, if any, and take no more readings."""
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        self._open = None

    def _read(self, e0, e1) -> Optional[float]:
        if e0 is None:
            return None
        self._probe._free += (e0, e1)
        return e0.elapsed_time(e1) / 1e3


class _Off:
    """The phases of an engine call without a probe: nothing is read."""

    __slots__ = ()

    def next(self, name: str, device: bool = True, **data: Any) -> None:
        pass

    def fence(self) -> None:
        pass

    def end(self) -> None:
        pass


OFF = _Off()


@contextlib.contextmanager
def lent(probes: Sequence[Probe]) -> Iterator[None]:
    """Lend each probe to its server's engines for the ``with`` block (one
    session step)."""
    for p in probes:
        p.server.prefill.probe = p.server.decode.probe = p
    try:
        yield
    finally:
        for p in probes:
            p.drop()
            p.server.prefill.probe = p.server.decode.probe = None
