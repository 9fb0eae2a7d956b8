"""The Kairos scheduling algorithms as fixed-shape tensor programs on a
device (port of ``repro.core.jax_sched``; renamed because this package
never imports JAX).

Real deployments keep scheduling on the host (`repro_torch.policies`), but
at scale the scheduler itself becomes a hot loop (thousands of active
slots, every ~10 ms). These versions run the same math as
`repro_torch.core.predictor` and the registered policies over padded
request-state tensors, on the device the tensors lie on, with no copy to
the host, so they can run beside the device step. The two sequential scans
of the reference (``jax.lax.scan``) are the ``sched_scan`` kernels
(`repro_torch.kernels.sched_scan.ops`, their plain versions on the CPU);
everything else is tensor code.

Conventions, as in the reference: slot tensors of length N; ``active``
masks real requests; an inactive slot sorts last; slot index is the
deterministic tie-breaker (``torch.argsort(stable=True)``, which mirrors
rid order on the host). Scalars (``t_now``, ``mu``, the SLOs) may be Python
numbers or tensors; they become f32 tensors on the slots' device, so the
card divides by a tensor and not by a host scalar (which CUDA turns into a
multiply by its reciprocal, one bit off the reference).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core.lut import StepTimeLUT
from repro_torch.core.request import Request
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.sched_scan.ops import fcfs_scan, slack_pack

_BIG = 3.0e38
_INT32_MAX = 2**31 - 1


def _f32(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _scatter(order: torch.Tensor, sorted_vals: torch.Tensor) -> torch.Tensor:
    """``out[order] = sorted_vals``: a sorted result back in slot order."""
    return torch.empty_like(sorted_vals).index_put_((order,), sorted_vals)


# ----------------------------------------------------------------------------
# Algorithm 2: FCFS finish-time prediction (max-plus scan)
# ----------------------------------------------------------------------------

def fcfs_finish_times(
    arrivals: torch.Tensor,  # (N,) f32
    remaining: torch.Tensor,  # (N,) f32 tokens
    active: torch.Tensor,  # (N,) bool
    t_now,
    mu,  # tokens/sec
) -> torch.Tensor:
    """Finish times under FCFS (t_i = max(t_{i-1}, a_i) + d_i) per slot."""
    dev = arrivals.device
    durs = torch.where(active, remaining / torch.clamp_min(_f32(mu, dev), 1e-9), 0.0)
    order = torch.argsort(torch.where(active, arrivals, _BIG), stable=True)
    fin_sorted = fcfs_scan(arrivals[order].contiguous(), durs[order].contiguous(),
                           _f32(t_now, dev).reshape(1))
    return _scatter(order, fin_sorted)


# ----------------------------------------------------------------------------
# Algorithm 1: urgency-based prefill selection
# ----------------------------------------------------------------------------

def urgency_scores(arrivals, input_lens, remaining, active, t_now, mu, slo_ttft) -> torch.Tensor:
    dev = arrivals.device
    slo = _f32(slo_ttft, dev)
    finish = fcfs_finish_times(arrivals, remaining, active, t_now, mu)
    slack = slo - (finish - arrivals)
    u = (slack / slo) / torch.clamp_min(input_lens, 1.0)
    return torch.where(active & (remaining > 0), u, -_BIG)


def urgency_select(
    arrivals: torch.Tensor,
    input_lens: torch.Tensor,
    remaining: torch.Tensor,  # (N,) f32 remaining prefill tokens
    active: torch.Tensor,
    t_now,
    mu,
    slo_ttft,
    budget: int,
) -> torch.Tensor:
    """Tokens of each slot to prefill this step (sum <= budget)."""
    u = urgency_scores(arrivals, input_lens, remaining, active, t_now, mu, slo_ttft)
    order = torch.argsort(-u, stable=True)
    rem_s = torch.where(active, remaining, 0.0)[order]
    cum = torch.cumsum(rem_s, 0)
    take_s = torch.clamp(budget - (cum - rem_s), min=torch.zeros_like(rem_s), max=rem_s)
    return _scatter(order, take_s)


# ----------------------------------------------------------------------------
# LUT lookup
# ----------------------------------------------------------------------------

def _bucket(edges: torch.Tensor, x) -> torch.Tensor:
    x = torch.as_tensor(x, device=edges.device).to(edges.dtype)
    i = torch.searchsorted(edges, x, right=True) - 1
    return torch.clamp(i, 0, edges.shape[0] - 1)


def lut_lookup(
    table: torch.Tensor,  # (NB, NS) f32 seconds
    bsz_edges: torch.Tensor,  # (NB,) int32 ascending bucket lower edges
    seq_edges: torch.Tensor,  # (NS,) int32
    bsz,  # int32 (any shape)
    seq,  # int32 (same shape)
) -> torch.Tensor:
    return table[_bucket(bsz_edges, bsz), _bucket(seq_edges, seq)]


# ----------------------------------------------------------------------------
# Algorithm 3: slack-guided decode selection
# ----------------------------------------------------------------------------

class SlackSelection(NamedTuple):
    selected: torch.Tensor  # (N,) bool: decode these this step
    slack: torch.Tensor  # (N,) f32 per-request slack (Eq. 2), NaN where inactive
    s_min: torch.Tensor  # () f32
    batch_size: torch.Tensor  # () int32 |B|


def slack_select(
    seq_lens: torch.Tensor,  # (N,) int32 current sequence length
    n_gen: torch.Tensor,  # (N,) int32 tokens generated so far
    first_token_t: torch.Tensor,  # (N,) f32
    active: torch.Tensor,  # (N,) bool
    t_now,
    slo_tpot,  # (N,) or scalar
    table: torch.Tensor,
    bsz_edges: torch.Tensor,
    seq_edges: torch.Tensor,
) -> SlackSelection:
    dev = seq_lens.device
    elapsed = _f32(t_now, dev) - first_token_t
    t1 = lut_lookup(table, bsz_edges, seq_edges, torch.ones_like(seq_lens), seq_lens)
    slack = _f32(slo_tpot, dev) * (n_gen + 1).float() - elapsed - t1
    slack = torch.where(active, slack, _BIG)
    s_min = slack.min()

    order = torch.argsort(torch.where(active, seq_lens, _INT32_MAX), stable=True)
    sel_s, count = slack_pack(seq_lens[order].contiguous(), active[order].contiguous(),
                              s_min.reshape(1), table.contiguous(), bsz_edges.contiguous(),
                              seq_edges.contiguous())
    selected = _scatter(order, sel_s)
    bsz = count[0]
    # fallback: nothing packs -> decode all active (Alg. 3 lines 19-21)
    none = bsz == 0
    selected = torch.where(none, active, selected)
    bsz = torch.where(none, active.sum(dtype=torch.int32), bsz)
    return SlackSelection(selected, torch.where(active, slack, float("nan")), s_min, bsz)


# ----------------------------------------------------------------------------
# Running-mean LUT update (device-side mirror of StepTimeLUT.update)
# ----------------------------------------------------------------------------

def lut_update(
    table: torch.Tensor,
    counts: torch.Tensor,
    bsz_edges: torch.Tensor,
    seq_edges: torch.Tensor,
    bsz,
    seq,
    observed,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """New (table, counts) with cell [bsz, seq] moved to the running mean
    that includes ``observed``; the inputs are left as they are."""
    idx = (_bucket(bsz_edges, bsz), _bucket(seq_edges, seq))
    c = counts[idx]
    new_mean = (table[idx] * c + _f32(observed, table.device)) / (c + 1.0)
    return table.index_put(idx, new_mean), counts.index_put(idx, c + 1.0)


# ----------------------------------------------------------------------------
# Slot tensors from the host's request state
# ----------------------------------------------------------------------------

def lut_tensors(lut: StepTimeLUT, device: DeviceLike = "cuda") -> Tuple[torch.Tensor, ...]:
    """(table f32, bsz_edges int32, seq_edges int32) of ``lut`` on ``device``."""
    dev = resolve_device(device)
    bsz_edges, seq_edges, table = lut.as_arrays()
    return (torch.as_tensor(table, device=dev), torch.as_tensor(bsz_edges, device=dev),
            torch.as_tensor(seq_edges, device=dev))


def prefill_slots(queue: Sequence[Request], n: Optional[int] = None,
                  device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """A prefill queue as ``n`` slots (``len(queue)`` where None; the rest
    inactive): arrivals, input_lens, remaining (prefill tokens left), active
    and slo_ttft, the arguments of `urgency_select`, slot i = queue[i]."""
    dev = resolve_device(device)
    n = len(queue) if n is None else n

    def f32(xs, pad: float = 0.0):
        return torch.tensor(list(xs) + [pad] * (n - len(queue)), dtype=torch.float32,
                            device=dev)

    return dict(
        arrivals=f32(r.arrival for r in queue),
        input_lens=f32(r.input_len for r in queue),
        remaining=f32(r.remaining_prefill_tokens for r in queue),
        active=torch.arange(n, device=dev) < len(queue),
        slo_ttft=f32((r.slo.ttft for r in queue), pad=1.0),
    )


def decode_slots(active: Sequence[Request], n: Optional[int] = None,
                 device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """Decoding requests as ``n`` slots: seq_lens, n_gen, first_token_t,
    active and slo_tpot, the arguments of `slack_select`. As the host's
    actionable slack (`SlackDecodeScheduler`), a request paces its decoded
    tokens from ``decode_start`` where it has one, else its generated tokens
    from its first token."""
    dev = resolve_device(device)
    n = len(active) if n is None else n
    k = n - len(active)

    def base(r):
        return ((r.decode_start, r.n_decoded) if r.decode_start is not None
                else (r.first_token_time, r.n_generated))

    return dict(
        seq_lens=torch.tensor([r.seq_len for r in active] + [0] * k, dtype=torch.int32,
                              device=dev),
        n_gen=torch.tensor([base(r)[1] for r in active] + [0] * k, dtype=torch.int32,
                           device=dev),
        first_token_t=torch.tensor([base(r)[0] for r in active] + [0.0] * k,
                                   dtype=torch.float32, device=dev),
        active=torch.arange(n, device=dev) < len(active),
        slo_tpot=torch.tensor([r.slo.tpot for r in active] + [1.0] * k, dtype=torch.float32,
                              device=dev),
    )
