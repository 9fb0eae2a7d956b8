"""The traced run's device view: ``torch.profiler`` over a fixed slice of
the measured window, reduced to the device's busy time (the union of its
activity intervals), device time by kernel group, the attention kernels'
summed time against the calls the benchmark's wrappers counted, and the
idle gaps labelled by the host range they fell in.

The grouping and the range arithmetic are copied from the port's
``launch/profile.py`` (``kernel_group``, ``device_kernels``); the busy time
here is the union of intervals, not their sum, so overlapping activity is
counted once.

A slice whose trace holds fewer attention kernels than the wrappers
launched (the profiler drops events now and then) is not used: the run
profiles a second slice and says so, and a share is only ever computed
from a complete slice.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

GROUPS = (
    ("prefill_attention", ("prefill_attention_wgmma", "prefill_attention_f32")),
    ("decode_attention", ("decode_split", "decode_combine")),
    ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "cublas", "sm90_")),
    ("copy/index", ("index", "gather", "scatter", "copy", "memcpy", "memset", "cat")),
)
# the kernel that marks one call of each attention wrapper
CALL_KERNEL = {"prefill_attention": ("prefill_attention_wgmma", "prefill_attention_f32"),
               "decode_attention": ("decode_split",)}
RANGES = ("kb.prefill_chunk", "kb.decode_step", "kb.session_step")
SLICES = 2  # the second is used only where the first is incomplete
LONGEST_S = 20.0  # a slice waits this long at most for both attention kernels
GAP_LABEL = {"kb.prefill_chunk": "prefill round", "kb.decode_step": "decode step",
             "kb.session_step": "scheduler", None: "outside the engine"}


def kernel_group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _holder(spans: Sequence[Tuple[float, float, str]], t: float) -> Optional[str]:
    """The label of the span in ``spans`` (sorted, not overlapping) that
    holds ``t``, if any."""
    i = bisect.bisect_right(spans, (t, float("inf"), "")) - 1
    if i >= 0 and spans[i][0] <= t <= spans[i][1]:
        return spans[i][2]
    return None


def reduce_trace(device: Sequence[Tuple[str, float, float]],
                 ranges: Sequence[Tuple[str, float, float]], window_s: float,
                 launches: Dict[str, int]) -> Dict:
    """The slice's summary from its device activities ``(name, start_us,
    end_us)`` and host ranges ``(label, start_us, end_us)``; ``launches``
    are the attention wrappers' call counts in the slice."""
    busy = union([(a, b) for _, a, b in device])
    busy_s = sum(b - a for a, b in busy) / 1e6
    by_group: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    calls: Dict[str, int] = defaultdict(int)
    for name, a, b in device:
        by_group[kernel_group(name)] += (b - a) / 1e6
        by_name[name] += (b - a) / 1e6
        for k, keys in CALL_KERNEL.items():
            if any(x in name for x in keys):
                calls[k] += 1
    complete = {k: calls[k] == n for k, n in launches.items()}
    # idle gaps between device activity, by the innermost host range
    # holding the gap's midpoint (engine calls lie inside a session step)
    inner = sorted((a, b, n) for n, a, b in ranges if n != "kb.session_step")
    outer = sorted((a, b, n) for n, a, b in ranges if n == "kb.session_step")
    gaps: Dict[str, float] = defaultdict(float)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        label = _holder(inner, mid) or _holder(outer, mid)
        gaps[GAP_LABEL[label]] += (s1 - e0) / 1e6
    return dict(
        window_s=window_s, busy_s=busy_s, group_s=dict(by_group),
        top_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1])[:10],
        calls=dict(calls), launches=dict(launches), complete=complete,
    )


class Slicer:
    """Starts and stops ``torch.profiler`` between engine steps: a slice of
    ``length`` seconds (virtual time) from ``start``, held open until every
    counter has moved (each attention kernel has run in it) or `LONGEST_S`
    seconds have passed; then a second slice right after it. Both are
    reduced once the window has closed; the second is used only where the
    first came back incomplete."""

    def __init__(self, start: float, length: float, counters: Dict):
        self.start_at, self.length = start, length
        self.counters = counters  # name -> callable giving the wrapper's launch count
        self.raw: List[Tuple] = []  # (profile, window_s, launches, (t0, t1) virtual)
        self._prof = None
        self._t0 = self._t0v = 0.0
        self._base: Dict[str, int] = {}

    def before_step(self, now: float) -> None:
        if self._prof is not None or len(self.raw) >= SLICES or now < self.start_at:
            return
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.start()
        self._base = {k: f() for k, f in self.counters.items()}
        self._t0, self._t0v = time.monotonic(), now

    def after_step(self, now: float) -> None:
        if self._prof is None or now < self._t0v + self.length:
            return
        launches = {k: f() - self._base[k] for k, f in self.counters.items()}
        if not all(launches.values()) and now < self._t0v + LONGEST_S:
            return
        window_s = time.monotonic() - self._t0
        self._prof.stop()
        self.raw.append((self._prof, window_s, launches, (self._t0v, now)))
        self._prof = None
        self.start_at = now

    def close(self) -> None:
        """Stop a slice still running when the window closes (it is dropped)."""
        if self._prof is not None:
            self._prof.stop()
            self._prof = None

    def result(self) -> Optional[Dict]:
        """The first complete slice's summary, with the number of slices
        looked at; None if none was complete."""
        for i, (prof, window_s, launches, span) in enumerate(self.raw):
            device, ranges = [], []
            for e in prof.events():
                if e.device_type.name == "CUDA":
                    if not e.is_user_annotation and e.name not in RANGES:
                        device.append((e.name, e.time_range.start, e.time_range.end))
                elif e.name in RANGES:
                    ranges.append((e.name, e.time_range.start, e.time_range.end))
            s = reduce_trace(device, ranges, window_s, launches)
            if all(s["complete"].values()):
                return dict(s, span=span, slice_used=i + 1)
        return None
