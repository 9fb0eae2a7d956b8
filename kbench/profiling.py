"""The traced run's device view: ``torch.profiler`` over a fixed slice of
the measured window, reduced to the device's busy time (the union of its
activity intervals), device time by kernel group and by kernel name, the
attention kernels' summed time against the calls the benchmark's wrappers
counted, the idle gaps labelled by the host range they fell in, and for
each of the program's own ``record_function`` ranges (every range not named
``kb.*``) its count, host length, kernel time and idle gaps.

A kernel is put in the program ranges that held its launch on the host
(the runtime call of the kernel's correlation id); a kernel whose launch
the trace lacks, by the ranges' device-side annotations (the trace's
``is_user_annotation`` events on the card, each spanning a range's first
kernel to its last) that hold its midpoint. The annotations alone misplace
kernels now and then: on the H100 (torch 2.11) one slice's
``decode.gather`` annotations held GEMMs and attention kernels that only
the forward launches. An idle gap is put in a range by its midpoint on the
host range, as the ``kb.*`` labels are. Ranges nest by containment: a range
inside another is named by the path of names, ``decode.forward/moe.experts``.

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
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

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


def nest(ranges: Sequence[Tuple[str, float, float]]) -> List[Tuple[str, float, float]]:
    """``(path, start, end)`` of each ``(name, start, end)``: its name behind
    the names of the ranges that hold it, joined by ``/``."""
    out: List[Tuple[str, float, float]] = []
    stack: List[Tuple[str, float, float]] = []
    for name, a, b in sorted(ranges, key=lambda r: (r[1], -r[2])):
        while stack and not (stack[-1][1] <= a and b <= stack[-1][2]):
            stack.pop()
        stack.append((f"{stack[-1][0]}/{name}" if stack else name, a, b))
        out.append(stack[-1])
    return out


def _inside(intervals: Sequence[Tuple[float, float]], t: np.ndarray) -> np.ndarray:
    """Which of the times ``t`` lie in one of ``intervals`` (not overlapping
    one another)."""
    if not intervals:
        return np.zeros(len(t), dtype=bool)
    iv = np.array(sorted(intervals), dtype=float)
    i = np.searchsorted(iv[:, 0], t, side="right") - 1
    return (i >= 0) & (t <= iv[np.maximum(i, 0), 1])


def program_ranges(device: Sequence[Tuple[str, float, float, Optional[float]]],
                   program: Sequence[Tuple[str, float, float]],
                   annotations: Sequence[Tuple[str, float, float]],
                   gaps: Sequence[Tuple[float, float]]) -> Dict[str, Dict]:
    """For each path of the program's host ranges ``program``: their
    ``count``, summed ``host_s``, the ``idle_s`` of the ``gaps`` whose
    midpoint they hold, and the device time of the kernels inside them,
    ``device_s`` in all and by kernel name (``kernels``). A kernel is inside
    where its launch (its fourth field) lies in the path's host ranges; one
    with no launch (None), where its midpoint lies in the path's
    ``annotations``; ``by_annotation`` counts those."""
    host: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    for path, a, b in nest(program):
        host[path].append((a, b))
    dev: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    for path, a, b in nest(annotations):
        dev[path].append((a, b))
    names = [d[0] for d in device]
    dur = np.array([(d[2] - d[1]) / 1e6 for d in device], dtype=float)
    mid = np.array([0.5 * (d[1] + d[2]) for d in device], dtype=float)
    launch = np.array([np.nan if d[3] is None else d[3] for d in device], dtype=float)
    gap_mid = np.array([0.5 * (a + b) for a, b in gaps], dtype=float)
    gap_s = np.array([(b - a) / 1e6 for a, b in gaps], dtype=float)
    unlaunched = np.isnan(launch)
    out = {}
    for path in sorted(set(host) | set(dev)):
        inside = np.where(unlaunched, _inside(dev[path], mid), _inside(host[path], launch))
        kernels: Dict[str, Dict] = {}
        for k in np.flatnonzero(inside):
            e = kernels.setdefault(names[k], dict(device_s=0.0, count=0))
            e["device_s"] += float(dur[k])
            e["count"] += 1
        out[path] = dict(
            count=len(host[path]), host_s=sum(b - a for a, b in host[path]) / 1e6,
            device_s=float(dur[inside].sum()),
            idle_s=float(gap_s[_inside(host[path], gap_mid)].sum()),
            kernels=kernels, by_annotation=int((inside & unlaunched).sum()))
    return out


def reduce_trace(device: Sequence[Tuple[str, float, float, Optional[float]]],
                 ranges: Sequence[Tuple[str, float, float]], window_s: float,
                 launches: Dict[str, int], program: Sequence[Tuple[str, float, float]],
                 annotations: Sequence[Tuple[str, float, float]],
                 wrappers: Dict[str, int]) -> Dict:
    """The slice's summary from its device activities ``(name, start_us,
    end_us, launch_us)`` (``launch_us``: the host time of the launch, None
    where unknown), the benchmark's host ranges ``(label, start_us,
    end_us)``, and the program's host ranges and device annotations
    ``(name, start_us, end_us)``; ``launches`` are the attention wrappers'
    call counts in the slice, ``wrappers`` those of every kernel wrapper."""
    busy = union([(a, b) for _, a, b, _ in device])
    busy_s = sum(b - a for a, b in busy) / 1e6
    by_group: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    count: Dict[str, int] = defaultdict(int)
    calls: Dict[str, int] = defaultdict(int)
    for name, a, b, _ in device:
        by_group[kernel_group(name)] += (b - a) / 1e6
        by_name[name] += (b - a) / 1e6
        count[name] += 1
        for k, keys in CALL_KERNEL.items():
            if any(x in name for x in keys):
                calls[k] += 1
    complete = {k: calls[k] == n for k, n in launches.items()}
    # idle gaps between device activity, by the innermost host range
    # holding the gap's midpoint (engine calls lie inside a session step)
    inner = sorted((a, b, n) for n, a, b in ranges if n != "kb.session_step")
    outer = sorted((a, b, n) for n, a, b in ranges if n == "kb.session_step")
    idle = [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:])]
    gaps: Dict[str, float] = defaultdict(float)
    for e0, s1 in idle:
        mid = 0.5 * (e0 + s1)
        label = _holder(inner, mid) or _holder(outer, mid)
        gaps[GAP_LABEL[label]] += (s1 - e0) / 1e6
    return dict(
        window_s=window_s, busy_s=busy_s, group_s=dict(by_group),
        top_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1])[:10],
        calls=dict(calls), launches=dict(launches), complete=complete,
        kernels={n: dict(device_s=by_name[n], count=count[n]) for n in by_name},
        program_ranges=program_ranges(device, program, annotations, idle),
        wrapper_launches=dict(wrappers),
    )


class Slicer:
    """Starts and stops ``torch.profiler`` between engine steps: a slice of
    ``length`` seconds (virtual time) from ``start``, held open until every
    counter has moved (each attention kernel has run in it) or `LONGEST_S`
    seconds have passed; then a second slice right after it. Both are
    reduced once the window has closed; the second is used only where the
    first came back incomplete."""

    def __init__(self, start: float, length: float, counters: Dict[str, Callable[[], int]],
                 wrappers: Dict[str, Callable[[], int]]):
        self.start_at, self.length = start, length
        self.counters = counters  # name -> callable giving the wrapper's launch count
        self.wrappers = wrappers  # the same for every kernel wrapper: counted only
        # (profile, window_s, launches, (t0, t1) virtual, wrappers' launches)
        self.raw: List[Tuple] = []
        self._prof = None
        self._t0 = self._t0v = 0.0
        self._base: Dict[str, int] = {}
        self._wbase: Dict[str, int] = {}

    def before_step(self, now: float) -> None:
        if self._prof is not None or len(self.raw) >= SLICES or now < self.start_at:
            return
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.start()
        self._base = {k: f() for k, f in self.counters.items()}
        self._wbase = {k: f() for k, f in self.wrappers.items()}
        self._t0, self._t0v = time.monotonic(), now

    def after_step(self, now: float) -> None:
        if self._prof is None or now < self._t0v + self.length:
            return
        launches = {k: f() - self._base[k] for k, f in self.counters.items()}
        if not all(launches.values()) and now < self._t0v + LONGEST_S:
            return
        window_s = time.monotonic() - self._t0
        self._prof.stop()
        wrappers = {k: f() - self._wbase[k] for k, f in self.wrappers.items()}
        self.raw.append((self._prof, window_s, launches, (self._t0v, now), wrappers))
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
        for i, (prof, window_s, launches, span, wrappers) in enumerate(self.raw):
            device, ranges, program, annotations = split_events(prof.events())
            s = reduce_trace(device, ranges, window_s, launches, program, annotations, wrappers)
            if all(s["complete"].values()):
                return dict(s, span=span, slice_used=i + 1)
        return None


def split_events(events) -> Tuple[List, List, List, List]:
    """The profiler's events as `reduce_trace` takes them: the device
    activities with their launch times, the benchmark's ``kb.*`` host
    ranges, and the program's host ranges and device annotations. A
    kernel's launch is the host runtime call (``cuda*``, ``cu*``) of the
    kernel's correlation id."""
    device, ranges, program, annotations = [], [], [], []
    launch_at: Dict[int, float] = {}
    for e in events:
        span = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type.name == "CUDA":
            if not e.is_user_annotation and e.name not in RANGES:
                device.append(span + (e.id,))
            elif e.is_user_annotation and not e.name.startswith("kb."):
                annotations.append(span)
        elif e.name in RANGES:
            ranges.append(span)
        elif e.is_user_annotation and not e.name.startswith("kb."):
            program.append(span)
        elif e.name.startswith("cu"):
            launch_at[e.id] = e.time_range.start
    device = [(n, a, b, launch_at.get(k)) for n, a, b, k in device]
    return device, ranges, program, annotations
