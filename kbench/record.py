"""Helpers the metric readers share: which requests, tokens and spans of a
run's record fall in the measured window. A record (``bench.run_cell``)
holds, in virtual seconds: ``window`` (t0, t1); ``rows``, one per request
(``due``, ``times`` of every token its client received, ``prefill_start``
from the traced run); ``prefill_spans`` (t0, t1, tokens, start position);
``decode_spans`` (t0, t1, lanes, bucket, kv lengths of the bucket);
``steps`` (t, batch, step_time) of the traced run's ``DECODE_STEP``
events; ``events`` (type, t, rid, data) of every event of the traced run's
``TraceRecorder``, ``data`` whole; ``program_spans`` (name, pool, t0, t1,
device_s, data) of the program's own spans in the traced run (`device_s`
None off the card or for a phase timed on the host only); ``model`` (the
configuration file); ``setup_s``; ``profile`` (`profiling.reduce_trace`'s
summary of the profiled slice, or None). The untraced run's ``steps``,
``events`` and ``program_spans`` are empty.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple


def due_in_window(rec: Dict) -> List[Dict]:
    t0, t1 = rec["window"]
    return [r for r in rec["rows"] if t0 <= r["due"] < t1]


def tokens_in_window(row: Dict, rec: Dict) -> List[float]:
    t0, t1 = rec["window"]
    return [t for t in row["times"] if t0 <= t <= t1]


def spans_in_window(spans, rec: Dict) -> Iterator[tuple]:
    """Spans that ended inside the window."""
    t0, t1 = rec["window"]
    return (s for s in spans if t0 <= s[1] <= t1)


def profiled(spans, rec: Dict) -> Iterator[tuple]:
    """Spans inside the profiled slice."""
    a, b = rec["profile"]["span"]
    return (s for s in spans if a <= s[0] and s[1] <= b)


def program_spans(rec: Dict, name: str) -> List[Tuple]:
    """The program's spans named ``name`` that ended inside the window."""
    t0, t1 = rec["window"]
    return [s for s in rec["program_spans"] if s[0] == name and t0 <= s[3] <= t1]


def engine_calls(rec: Dict, family: str) -> List[List[Tuple]]:
    """The program's spans of one family (``decode`` for ``decode.*``),
    grouped by engine call, of the calls whose last span ended inside the
    window. One call's phases come in together and each begins where the
    one before it ended (a ``decode.*`` call runs from its ``decode.gather``
    to its ``decode.wait``); a span that repeats a name of the call, begins
    later than the last one ended, or comes from another pool begins the
    next call."""
    calls: List[List[Tuple]] = []
    for s in rec["program_spans"]:
        if s[0].split(".")[0] != family:
            continue
        last = calls[-1][-1] if calls else None
        if (last is None or s[1] != last[1] or s[2] != last[3]
                or any(s[0] == x[0] for x in calls[-1])):
            calls.append([])
        calls[-1].append(s)
    t0, t1 = rec["window"]
    return [c for c in calls if t0 <= c[-1][3] <= t1]
