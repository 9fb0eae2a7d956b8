"""The benchmark's frozen yardstick: the H100's peaks, the operations and
bytes of the two attention kernels, the model-FLOPs formula and the
percentile rule. Copied from the port at the commit that defined the
benchmark, so that a later change to the program cannot move the ruler it
is measured with; ``kbench/tests/test_kbench_yardstick.py`` holds the
copies equal to the port's (at window 0, the only window the port's count
knows).

Attention is counted per layer at the layer's own window
(``layer_windows``): a query at position p of a layer with window w > 0
sees the keys k with p - w < k <= p; with w = 0 every k <= p.
"""
from __future__ import annotations

import statistics
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# NVIDIA H100 Tensor Core GPU data sheet, SXM column: dense bf16 without
# sparsity, HBM3 bandwidth, at the full 700 W power limit.
PEAK_FLOPS_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card can take for work of ``flops`` (bf16 on the
    tensor cores) and ``nbytes`` of HBM traffic."""
    return max(flops / PEAK_FLOPS_BF16, nbytes / HBM_BYTES_PER_S)


def layer_windows(m: Dict) -> List[int]:
    """Each layer's attention window, how many positions a query sees,
    itself included (0: the whole causal prefix): the configuration's
    ``attention_windows``, one a layer; every layer 0 where it states none."""
    n = m["num_layers"]
    ws = m.get("attention_windows")
    if ws is None:
        return [0] * n
    if len(ws) != n or any(type(w) is not int or w < 0 for w in ws):
        raise ValueError(f"configuration {m.get('name')!r}: attention_windows must list "
                         f"{n} whole numbers >= 0, one a layer; got {ws!r}")
    return list(ws)


def window_groups(m: Dict) -> List[Tuple[int, int]]:
    """(window, number of layers with it), in the order the layers first
    have each window; ``[(0, num_layers)]`` where no window is stated."""
    return list(Counter(layer_windows(m)).items())


def _pairs(st: int, sq: int, kv: int) -> int:
    """The sum over rows j < sq of min(max(0, st + j + 1), kv): the keys
    k < kv with k <= st + j, for a ``st`` that may be negative."""
    skip = min(sq, max(0, -st))  # rows whose position is below 0 see nothing
    st, sq = st + skip, sq - skip
    below = min(sq, max(0, kv - st))  # rows j with st + j + 1 <= kv
    return below * st + below * (below + 1) // 2 + (sq - below) * kv


def prefill_visible(starts: Sequence[int], sq: int, kv_lens: Sequence[int],
                    window: int = 0) -> Tuple[int, int]:
    """(visible pairs, K/V rows read) of one prefill-attention call whose
    sequence ``i`` holds ``sq`` query rows at positions ``starts[i] ..``
    (padding rows included) over ``kv_lens[i]`` cache rows, in a layer of
    attention window ``window``: the rows read are those some query sees."""
    visible = rows = 0
    for st, kv in zip(starts, kv_lens, strict=True):
        visible += _pairs(st, sq, kv)
        rows += min(st + sq, kv)
        if window:  # less the keys at or below p - window, for each query p
            visible -= _pairs(st - window, sq, kv)
            rows -= min(max(0, st - window + 1), kv)
    return visible, rows


def decode_rows(kv_lens: Sequence[int], window: int = 0) -> int:
    """K/V rows one decode-attention call reads in a layer of attention
    window ``window``: each lane's ``kv_len``, at most ``window``."""
    return sum(min(kv, window) for kv in kv_lens) if window else sum(kv_lens)


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
    pair each layer sees at its window (``window_groups``)."""
    hq, dh = m["num_heads"], m["head_dim"]
    attn = sum(4.0 * layers * hq * dh * prefill_visible([start], n, [start + n], w)[0]
               for w, layers in window_groups(m))
    return 2.0 * active_params_nonembed(m) * n + attn


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
