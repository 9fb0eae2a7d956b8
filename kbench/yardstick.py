"""The benchmark's frozen yardstick: the H100's peaks, the operations and
bytes of the two attention kernels, the model-FLOPs formula and the
percentile rule. Copied from the port at the commit that defined the
benchmark, so that a later change to the program cannot move the ruler it
is measured with; ``kbench/tests/test_kbench_yardstick.py`` holds the
copies equal to the port's.
"""
from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# NVIDIA H100 Tensor Core GPU data sheet, SXM column: dense bf16 without
# sparsity, HBM3 bandwidth, at the full 700 W power limit.
PEAK_FLOPS_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card can take for work of ``flops`` (bf16 on the
    tensor cores) and ``nbytes`` of HBM traffic."""
    return max(flops / PEAK_FLOPS_BF16, nbytes / HBM_BYTES_PER_S)


def prefill_visible(starts: Sequence[int], sq: int, kv_lens: Sequence[int]) -> Tuple[int, int]:
    """(visible pairs, K/V rows read) of one prefill-attention call whose
    sequence ``i`` holds ``sq`` query rows at positions ``starts[i] ..``
    (padding rows included) over ``kv_lens[i]`` cache rows."""
    visible = rows = 0
    for st, kv in zip(starts, kv_lens, strict=True):
        below = min(sq, max(0, kv - st))  # rows j with st + j + 1 <= kv
        visible += below * st + below * (below + 1) // 2 + (sq - below) * kv
        rows += min(st + sq, kv)
    return visible, rows


def prefill_work(b: int, sq: int, hq: int, hkv: int, dh: int, visible: int, kv_rows: int,
                 esize: int = 2) -> Tuple[int, int]:
    """(operations, bytes) of one prefill-attention forward call: 4 Hq Dh
    per visible pair; q and the output, the K/V rows read, q_pos and
    kv_len once each."""
    flops = 4 * hq * dh * visible
    nbytes = esize * (2 * b * sq * hq * dh + 2 * kv_rows * hkv * dh) + 4 * (b * sq + b)
    return flops, nbytes


def decode_work(b: int, hq: int, hkv: int, dh: int, tot: int, esize: int = 2) -> Tuple[int, int]:
    """(operations, bytes) of one decode-attention call over ``tot`` cache
    rows in all (the sum of kv_len): 4 Hq Dh per row; the K and V rows, q
    and the output once each, and kv_len."""
    flops = 4 * hq * dh * tot
    nbytes = esize * (2 * tot * hkv * dh + 2 * b * hq * dh) + 4 * b
    return flops, nbytes


def active_params_nonembed(m: Dict) -> int:
    """Parameters one token passes through, the embedding and the output
    head left out: attention, the MLP (for a mixture, the top-k experts
    and the router) and the two norms of every layer, and the final norm.
    ``m`` holds the configuration file's widths."""
    d, hd = m["d_model"], m["head_dim"]
    hq, hkv, f = m["num_heads"], m["num_kv_heads"], m["d_ff"]
    attn = d * hq * hd + 2 * d * hkv * hd + hq * hd * d
    if m.get("num_experts", 0):
        mlp = m["experts_per_token"] * 3 * d * f + d * m["num_experts"]
    else:
        mlp = 3 * d * f
    return m["num_layers"] * (attn + mlp + 2 * d) + d


def model_flops(m: Dict, start: int, n: int) -> float:
    """Forward FLOPs the model needs for ``n`` new tokens of one sequence
    at positions ``start .. start + n - 1``: 2 per active non-embedding
    parameter a token, and causal attention's 4 Hq Dh per (query, key)
    pair in every layer."""
    pairs = n * start + n * (n + 1) // 2
    return (2.0 * active_params_nonembed(m) * n
            + 4.0 * m["num_layers"] * m["num_heads"] * m["head_dim"] * pairs)


def percentile(values: Iterable[float], q: int) -> Optional[float]:
    """The ``q``-th percentile (1..99) by ``statistics.quantiles`` with the
    inclusive method; None for fewer than two values."""
    vals: List[float] = sorted(values)
    if len(vals) < 2:
        return None
    return statistics.quantiles(vals, n=100, method="inclusive")[q - 1]


def median(values: Iterable[float]) -> Optional[float]:
    vals = list(values)
    return statistics.median(vals) if vals else None
