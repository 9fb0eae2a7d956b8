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
sync), and the device time of the kernels each of them launched. The
profiler's own cost stretches the profiled wall, so the idle share it gives
is an upper bound. Weights are random (seed 0). ``--device`` defaults to
``cuda``; ``--device cpu --arch llama3-8b-smoke`` rehearses the script
without a card.
"""
from __future__ import annotations

import argparse
import subprocess
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.configs import get_config
from repro_torch.launch.smoke_workload import smoke_engine_config, smoke_requests
from repro_torch.models import build_model
from repro_torch.serving.engine import DisaggServer
from repro_torch.serving.session import ServeSession

_GROUPS = (
    ("prefill_attention", ("prefill_attention_wgmma", "prefill_attention_f32")),
    ("decode_attention", ("decode_split", "decode_combine")),
    ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "cublas", "sm90_")),
    ("copy/index", ("index", "gather", "scatter", "copy", "memcpy", "memset", "cat")),
)


_LABELS = ("prefill_chunk", "decode_step")


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in _GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


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

    events = prof.key_averages()
    dev = [e for e in events if e.device_type.name == "CUDA" and e.key not in _LABELS
           and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in dev)
    groups = defaultdict(float)
    for e in dev:
        groups[_group(e.key)] += e.self_device_time_total
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
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[profile] kernel {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:6d}  "
              f"{e.key[:90]}")
    for label, times in host_plain.items():
        print(f"[profile] host {label:14s} x{len(times):4d} mean "
              f"{1e3 * sum(times) / max(len(times), 1):.3f} ms unprofiled (ends in a device sync)")
    # a range's device time: the kernels launched inside it, from the CPU-side
    # range event (the same label's device-side span would count idle gaps)
    for e in events:
        if e.key in _LABELS and e.device_type.name == "CPU":
            print(f"[profile] device {e.key:14s} x{e.count:4d} mean "
                  f"{e.device_time_total / 1e3 / e.count:.3f} ms of kernels launched inside "
                  f"the range (profiled serve), "
                  f"{100 * e.device_time_total / max(busy_us, 1e-9):.1f}% of busy")


if __name__ == "__main__":
    main()
