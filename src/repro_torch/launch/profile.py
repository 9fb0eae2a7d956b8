"""Where a serve's device time goes: the smoke serve of ``chip_smoke.py``
(``launch/smoke_workload.py``) under ``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile [--page-size 64]

Serves the same 8 requests as ``chip_smoke.py`` (long-tail prompts of
64-1536 tokens, 32 output tokens, kairos-urgency / kairos-slack) once to
warm up, once unprofiled for the wall time, then again under the profiler,
and prints: both walls, the device's busy and idle share in the profiled
serve, device time by kernel group (the two attention kernels, matrix
products, copies and indexing, the rest), the top kernels by device time,
the host time of prefill chunks and decode steps (each ends in a device
sync), the device time of the kernels that ran inside each of them, and
the device time outside every range. A kernel belongs to the range whose
host interval holds its start (`range_device_time`): the range ends in a
device sync, so what it launched has run by its end. This counts the
kernels launched through ``ctypes`` too, which no ATen op encloses. The
profiler's own cost stretches the profiled wall, so the idle share it gives
is an upper bound. Weights are random (seed 0). ``--device`` defaults to
``cuda``; ``--device cpu --arch llama3-8b-smoke`` rehearses the script
without a card.
"""
from __future__ import annotations

import argparse
import bisect
import subprocess
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.configs import get_config
from repro_torch.launch.smoke_workload import smoke_engine_config, smoke_requests
from repro_torch.models import build_model
from repro_torch.serving.engine import DisaggServer
from repro_torch.serving.session import ServeSession

_GROUPS = (
    ("prefill_attention_bwd", ("prefill_bwd_",)),
    ("ssd_scan_bwd", ("ssd_state_bwd", "ssd_chunk_bwd", "ssd_bwd_reduce")),
    ("ssd_scan", ("ssd_state_pass", "ssd_chunk_out", "ssd_scan_kernel")),
    ("prefill_attention", ("prefill_attention_wgmma", "prefill_attention_f32")),
    ("decode_attention", ("decode_split", "decode_combine")),
    ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "cublas", "sm90_")),
    ("copy/index", ("index", "gather", "scatter", "copy", "memcpy", "memset", "cat")),
)


_LABELS = ("prefill_chunk", "decode_step")


def kernel_group(name: str) -> str:
    """The group of a device kernel's name, "other" where none matches."""
    low = name.lower()
    for group, keys in _GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def device_kernels(events) -> List[Tuple[str, float, float]]:
    """``(name, start_us, end_us)`` of every device activity in a profile's
    ``events()`` (kernels, copies, sets); the profiler's device-side copies
    of the ``record_function`` ranges are left out."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type.name == "CUDA" and not e.is_user_annotation
            and e.name not in _LABELS]


def range_device_time(
    events, kernels: Sequence[Tuple[str, float, float]], labels: Iterable[str] = _LABELS,
) -> Tuple[Dict[str, float], Dict[str, int], float]:
    """Device time (us) of ``kernels`` by the host range each started in:
    ``({label: us}, {label: ranges}, us outside every range)``. The ranges
    are the CPU-side ``record_function`` events named in ``labels``; they
    run one after another on the host thread and do not overlap. The
    per-label times plus the outside time sum to the kernels' total."""
    labels = tuple(labels)
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                   if e.name in labels and e.device_type.name == "CPU")
    starts = [s for s, _, _ in spans]
    inside = dict.fromkeys(labels, 0.0)
    count = dict.fromkeys(labels, 0)
    for _, _, name in spans:
        count[name] += 1
    outside = 0.0
    for _, k0, k1 in kernels:
        i = bisect.bisect_right(starts, k0) - 1
        if i >= 0 and k0 <= spans[i][1]:
            inside[spans[i][2]] += k1 - k0
        else:
            outside += k1 - k0
    return inside, count, outside


def _labelled(fn, label, sink):
    """``fn`` inside a profiler range named ``label``, its host time
    appended to ``sink``."""
    def wrapped(*args, **kw):
        with record_function(label):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            sink.append(time.perf_counter() - t0)
            return out
    return wrapped


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--page-size", type=int, default=0, help="paged KV page size; 0 = slots")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    model = build_model(cfg)
    params = model.init(0, device=args.device)
    ecfg = smoke_engine_config(args.page_size or None)

    def serve():
        server = DisaggServer(model, params, ecfg, device=args.device)
        host = {label: [] for label in _LABELS}
        server.prefill.run_chunk = _labelled(server.prefill.run_chunk, "prefill_chunk",
                                             host["prefill_chunk"])
        server.decode.step = _labelled(server.decode.step, "decode_step", host["decode_step"])
        session = ServeSession(server)
        t0 = time.perf_counter()
        session.run(smoke_requests(cfg.vocab_size))
        return time.perf_counter() - t0, host

    serve()  # warm-up: cuBLAS handles, allocator pools
    wall_plain, host_plain = serve()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall, _ = serve()

    kernels = device_kernels(prof.events())
    busy_us = sum(k1 - k0 for _, k0, k1 in kernels)
    groups, by_name = defaultdict(float), defaultdict(lambda: [0.0, 0])
    for name, k0, k1 in kernels:
        groups[kernel_group(name)] += k1 - k0
        by_name[name][0] += k1 - k0
        by_name[name][1] += 1
    card = "cpu"
    if torch.cuda.is_available():
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
    print(f"[profile] {cfg.name} {cfg.dtype}, {'paged' if args.page_size else 'slot'} KV, "
          f"8 requests x 32 tokens on {card}")
    busy = busy_us / 1e6
    print(f"[profile] serve wall {wall_plain:.4f} s unprofiled, {wall:.4f} s profiled; "
          f"device busy {busy:.4f} s: idle {100 * (1 - busy / wall):.1f}% of the profiled "
          f"wall (an upper bound), {100 * (1 - busy / wall_plain):.1f}% of the unprofiled "
          f"wall (same requests; the schedule may differ slightly)")
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile] group {g:18s} {us / 1e3:10.3f} ms  {100 * us / busy_us:5.1f}% of busy")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"[profile] kernel {us / 1e3:10.3f} ms  x{n:6d}  {name[:90]}")
    for label, times in host_plain.items():
        print(f"[profile] host {label:14s} x{len(times):4d} mean "
              f"{1e3 * sum(times) / max(len(times), 1):.3f} ms unprofiled (ends in a device sync)")
    inside, count, outside = range_device_time(prof.events(), kernels)
    for label in _LABELS:
        print(f"[profile] device {label:14s} x{count[label]:4d} mean "
              f"{inside[label] / 1e3 / max(count[label], 1):.3f} ms of kernels that ran "
              f"inside the range (profiled serve), total {inside[label] / 1e3:.3f} ms, "
              f"{100 * inside[label] / max(busy_us, 1e-9):.1f}% of busy")
    print(f"[profile] device outside every range {outside / 1e3:.3f} ms, "
          f"{100 * outside / max(busy_us, 1e-9):.1f}% of busy")
    for group in ("prefill_attention", "decode_attention"):
        attn = [k for k in kernels if kernel_group(k[0]) == group]
        split, _, rest = range_device_time(prof.events(), attn)
        print(f"[profile] {group} by range: " + ", ".join(
            f"{label} {split[label] / 1e3:.3f} ms" for label in _LABELS)
            + f", outside {rest / 1e3:.3f} ms")


if __name__ == "__main__":
    main()
