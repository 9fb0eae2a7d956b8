"""Helpers the metric readers share: which requests, tokens and spans of a
run's record fall in the measured window. A record (``bench.run_cell``)
holds, in virtual seconds: ``window`` (t0, t1); ``rows``, one per request
(``due``, ``times`` of every token its client received, ``prefill_start``
from the traced run); ``prefill_spans`` (t0, t1, tokens, start position);
``decode_spans`` (t0, t1, lanes, bucket, kv lengths of the bucket);
``steps`` (t, batch, step_time) of the traced run's ``DECODE_STEP``
events; ``model`` (the configuration file); ``setup_s``; ``profile``.
"""
from __future__ import annotations

from typing import Dict, Iterator, List


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
