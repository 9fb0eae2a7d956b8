"""Wrappers of the scheduler scans (``csrc/sched_scan.cu``): the
counterparts of the two ``jax.lax.scan`` loops of ``repro.core.jax_sched``
(not Pallas kernels), which `repro_torch.core.device_sched` calls.

On CPU tensors they call the plain versions (`ref.fcfs_scan_ref`,
`ref.slack_pack_ref`); on CUDA tensors they launch the kernel or raise.
Each kernel is one thread block that walks the slots in order (the kernel
source says why), and takes its scalars (``t0``, ``s_min``) as one-element
tensors on the card, so a scheduling step needs no copy to the host.

`work` is the operations and bytes of one decision's pair of calls, what
the kernels' bound counts (`roofline.analysis.bound`), `fcfs_work` and
`pack_work` its two parts; while a count of `roofline.op_stats` is active
each wrapper adds its part and runs its own path uncounted.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.checks import (
    check_no_grad,
    check_shape,
    check_tensors,
    ptr,
    require,
    stream_ptr,
)
from repro_torch.kernels.sched_scan.ref import fcfs_scan_ref, slack_pack_ref
from repro_torch.roofline import op_stats

_K = "sched_scan"
MAX_LUT = 4096  # NB * NS entries of the step-time table (MAX_LUT in the source)
MAX_EDGES = 256  # bucket edges per axis
_NO_GRAD = "a scheduling decision has no gradient"


def fcfs_work(n: int) -> Tuple[int, int]:
    """(operations, bytes) of `fcfs_scan` over ``n`` slots: a max and an add
    per slot; the f32 arrivals, durations and finish times, and t0."""
    return 2 * n, 4 * 3 * n + 4


def pack_work(n: int, lut: int, nb: int, ns: int) -> Tuple[int, int]:
    """(operations, bytes) of `slack_pack` over ``n`` slots, a table of
    ``lut`` entries and ``nb`` + ``ns`` edges: the pair's other 4 per slot;
    the int32 lengths, the flags in and out, the f32 table, the int32 edges,
    s_min and the count."""
    return 4 * n, (4 + 1 + 1) * n + 4 * lut + 4 * (nb + ns) + 8


def work(n: int, lut: int, nb: int, ns: int) -> Tuple[int, int]:
    """(operations, bytes) of one decision's `fcfs_scan` and `slack_pack`."""
    (f1, b1), (f2, b2) = fcfs_work(n), pack_work(n, lut, nb, ns)
    return f1 + f2, b1 + b2


def _lib() -> ctypes.CDLL:
    lib = build.load(_K)
    if lib.repro_fcfs_scan.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_fcfs_scan.argtypes = [p, p, p, p, i, p]  # a, d, t0, out, N, stream
        lib.repro_fcfs_scan.restype = ctypes.c_int
        # seq, act, s_min, table, bsz_edges, seq_edges, sel, count, N, NB, NS, stream
        lib.repro_slack_pack.argtypes = [p, p, p, p, p, p, p, p, i, i, i, p]
        lib.repro_slack_pack.restype = ctypes.c_int
    return lib


def _on_cpu(name: str, t: torch.Tensor) -> bool:
    """True for a CPU tensor (the plain version), False for a CUDA one;
    raises for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{_K}.{name}: unsupported device {t.device}")
    return False


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{_K}.{name}: kernel launch failed with cudaError {err}")


def fcfs_scan(a_s: torch.Tensor, d_s: torch.Tensor, t0: torch.Tensor) -> torch.Tensor:
    """(N,) f32 arrivals and durations sorted by arrival, t0 a one-element
    f32 tensor -> (N,) f32 finish times ``t_i = max(t_{i-1}, a_i) + d_i``."""
    if op_stats.ACTIVE is not None:
        with op_stats.kernel(_K, lambda: fcfs_work(a_s.shape[0])):
            return torch.empty_like(a_s) if a_s.is_meta else fcfs_scan(a_s, d_s, t0)
    if _on_cpu("fcfs_scan", a_s):
        return fcfs_scan_ref(a_s, d_s, t0)
    check_no_grad(f"{_K}.fcfs_scan", _NO_GRAD, a_s=a_s, d_s=d_s, t0=t0)
    n = a_s.shape[0]
    require(a_s.dim() == 1 and n >= 1, f"{_K}.fcfs_scan: a_s must be (N,), N >= 1")
    for name, t in (("a_s", a_s), ("d_s", d_s), ("t0", t0)):
        require(t.dtype == torch.float32, f"{_K}.fcfs_scan: {name} must be float32")
    check_shape(_K, "d_s", d_s, (n,))
    require(t0.numel() == 1, f"{_K}.fcfs_scan: t0 must hold one element")
    check_tensors(_K, a_s.device, (), a_s=a_s, d_s=d_s, t0=t0)
    out = torch.empty_like(a_s)
    _raise_on(_lib().repro_fcfs_scan(ptr(a_s), ptr(d_s), ptr(t0), ptr(out), n,
                                     stream_ptr(a_s.device)), "fcfs_scan")
    fcfs_scan.launches += 1
    return out


def slack_pack(
    seq_s: torch.Tensor,  # (N,) int32, slots sorted by sequence length
    act_s: torch.Tensor,  # (N,) bool
    s_min: torch.Tensor,  # one-element f32
    table: torch.Tensor,  # (NB, NS) f32
    bsz_edges: torch.Tensor,  # (NB,) int32 ascending
    seq_edges: torch.Tensor,  # (NS,) int32 ascending
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 3's greedy walk: (per-slot flags (N,) bool, batch size (1,)
    int32)."""
    if op_stats.ACTIVE is not None:
        with op_stats.kernel(_K, lambda: pack_work(seq_s.shape[0], table.numel(),
                                                   bsz_edges.numel(), seq_edges.numel())):
            if seq_s.is_meta:
                return (act_s.new_empty(seq_s.shape),
                        seq_s.new_empty((1,), dtype=torch.int32))
            return slack_pack(seq_s, act_s, s_min, table, bsz_edges, seq_edges)
    if _on_cpu("slack_pack", seq_s):
        return slack_pack_ref(seq_s, act_s, s_min, table, bsz_edges, seq_edges)
    check_no_grad(f"{_K}.slack_pack", _NO_GRAD, s_min=s_min, table=table)
    n = seq_s.shape[0]
    require(seq_s.dim() == 1 and n >= 1, f"{_K}.slack_pack: seq_s must be (N,), N >= 1")
    require(table.dim() == 2, f"{_K}.slack_pack: table must be (NB, NS)")
    nb, ns = table.shape
    require(1 <= nb <= MAX_EDGES and 1 <= ns <= MAX_EDGES and nb * ns <= MAX_LUT,
            f"{_K}.slack_pack: a table of {nb} x {ns} is beyond {MAX_EDGES} edges per axis "
            f"or {MAX_LUT} entries")
    for name, t, dt in (("seq_s", seq_s, torch.int32), ("act_s", act_s, torch.bool),
                        ("s_min", s_min, torch.float32), ("table", table, torch.float32),
                        ("bsz_edges", bsz_edges, torch.int32),
                        ("seq_edges", seq_edges, torch.int32)):
        require(t.dtype == dt, f"{_K}.slack_pack: {name} must be {dt}")
    check_shape(_K, "act_s", act_s, (n,))
    check_shape(_K, "bsz_edges", bsz_edges, (nb,))
    check_shape(_K, "seq_edges", seq_edges, (ns,))
    require(s_min.numel() == 1, f"{_K}.slack_pack: s_min must hold one element")
    check_tensors(_K, seq_s.device, (), seq_s=seq_s, act_s=act_s, s_min=s_min, table=table,
                  bsz_edges=bsz_edges, seq_edges=seq_edges)
    sel = torch.empty((n,), dtype=torch.bool, device=seq_s.device)
    count = torch.empty((1,), dtype=torch.int32, device=seq_s.device)
    _raise_on(_lib().repro_slack_pack(
        ptr(seq_s), ptr(act_s), ptr(s_min), ptr(table), ptr(bsz_edges), ptr(seq_edges),
        ptr(sel), ptr(count), n, nb, ns, stream_ptr(seq_s.device)), "slack_pack")
    slack_pack.launches += 1
    return sel, count


fcfs_scan.launches = 0  # kernel launches since the last reset
slack_pack.launches = 0
