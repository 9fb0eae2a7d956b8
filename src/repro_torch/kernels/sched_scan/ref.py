"""Plain PyTorch versions of the scheduler scans (``csrc/sched_scan.cu``):
the two ``jax.lax.scan`` loops of ``repro.core.jax_sched``, step by step
in f32, in the reference's order and arithmetic.

They walk the slots in a Python loop over CPU copies of the inputs and
return their results on the inputs' device: the CPU path of
`repro_torch.kernels.sched_scan.ops` and the yardstick the kernel is held
to on the card.
"""
from __future__ import annotations

from bisect import bisect_right
from typing import Tuple

import torch


def fcfs_scan_ref(a_s: torch.Tensor, d_s: torch.Tensor, t0: torch.Tensor) -> torch.Tensor:
    """FCFS finish times over slots already sorted by arrival:
    ``t_i = max(t_{i-1}, a_i) + d_i`` from ``t_{-1} = t0``, in f32
    (``jax_sched.fcfs_finish_times``'s scan)."""
    a, d = a_s.detach().cpu().float(), d_s.detach().cpu().float()
    t = t0.detach().cpu().float().reshape(())
    out = torch.empty_like(a)
    for i in range(a.shape[0]):
        t = torch.maximum(t, a[i]) + d[i]
        out[i] = t
    return out.to(a_s.device)


def _bucket(edges, x: int) -> int:
    """``clip(searchsorted(edges, x, side="right") - 1, 0, len - 1)``."""
    return min(max(bisect_right(edges, x) - 1, 0), len(edges) - 1)


def slack_pack_ref(
    seq_s: torch.Tensor,  # (N,) int32, slots sorted by sequence length
    act_s: torch.Tensor,  # (N,) bool
    s_min: torch.Tensor,  # () f32, the smallest slack
    table: torch.Tensor,  # (NB, NS) f32 step times
    bsz_edges: torch.Tensor,  # (NB,) int32 ascending
    seq_edges: torch.Tensor,  # (NS,) int32 ascending
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 3's greedy walk (``jax_sched.slack_select``'s scan): slot i
    joins the batch when it is active, the step time of the batch it would
    make, ``LUT[count + 1, seq_i]``, is within ``s_min``, and the batch's
    throughput improves, ``(count + 1) * t_cur > count * t_step`` in f32 (or
    the batch is empty). Returns the per-slot flags (N,) bool and the batch
    size (1,) int32."""
    seqs, acts = seq_s.tolist(), act_s.tolist()
    tab = table.detach().cpu().float()
    be, se = bsz_edges.tolist(), seq_edges.tolist()
    s_min = s_min.detach().cpu().float().reshape(())
    count, t_cur = 0, torch.zeros((), dtype=torch.float32)
    sel = torch.zeros(len(seqs), dtype=torch.bool)
    for i, (seq, act) in enumerate(zip(seqs, acts, strict=True)):
        t_step = tab[_bucket(be, count + 1), _bucket(se, seq)]
        improves = count == 0 or bool(
            torch.tensor(count + 1, dtype=torch.float32) * t_cur
            > torch.tensor(count, dtype=torch.float32) * t_step)
        if act and bool(t_step <= s_min) and improves:
            count, t_cur = count + 1, t_step
            sel[i] = True
    return sel.to(seq_s.device), torch.tensor([count], dtype=torch.int32, device=seq_s.device)
