"""Wrapper of the GQA decode attention kernel (``csrc/decode_attention.cu``).

Replaces the TPU kernel ``repro.kernels.decode_attention.kernel.
flash_decode_attention`` and its grouping/padding wrapper. On a CPU tensor
it calls the plain version (`ref.decode_attention_ref`); on a CUDA tensor
it launches the kernel or raises. The kernel is bound by the bytes of K and
V; it reads only the rows below ``kv_len``. It splits the KV axis into
fixed splits of `SPLIT_ROWS` rows, one block each, whose f32 partials go to
scratch allocated here and are merged by a second kernel in the same C call
(the kernel source says more).

`work` is the operations and bytes of one call, what the kernel's bound
counts (`roofline.analysis.bound`); while a count of `roofline.op_stats`
is active the wrapper adds it and runs its own path uncounted.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.checks import (
    DTYPE_CODE,
    HEAD_DIMS,
    check_local,
    check_no_grad,
    check_shape,
    check_tensors,
    ptr,
    stream_ptr,
)
from repro_torch.kernels.decode_attention.ref import SPLIT_ROWS, decode_attention_ref
from repro_torch.roofline import op_stats

_K = "decode_attention"
MAX_Q_PER_KV = 16  # query heads per KV head one block holds


def _lib() -> ctypes.CDLL:
    lib = build.load(_K)
    fn = lib.repro_decode_attention
    if fn.argtypes is None:
        ptr_t, int_t, float_t = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [
            ptr_t, ptr_t, ptr_t, ptr_t, ptr_t,  # q, k, v, kv_len, out
            ptr_t, ptr_t,  # scratch: partial accumulators, partial (m, l)
            int_t, int_t, int_t, int_t, int_t, int_t, int_t,  # B, S, Hq, Hkv, Dh, n_split, dtype
            float_t, float_t,  # scale, logit cap
            ptr_t,  # stream
        ]
        fn.restype = ctypes.c_int
    return lib


def work(b: int, hq: int, hkv: int, dh: int, tot: int, esize: int = 2) -> Tuple[int, int]:
    """(operations, bytes) of one call over ``tot`` cache rows in all (the
    sum of kv_len): 4 Hq Dh per row (q.k and p.v); the K and V rows read,
    q and the output, once each, in elements of ``esize`` bytes, and
    kv_len."""
    flops = 4 * hq * dh * tot
    nbytes = esize * (2 * tot * hkv * dh + 2 * b * hq * dh) + 4 * b
    return flops, nbytes


def _work_of(q, k, kv_len) -> Tuple[int, int]:
    """`work` at these inputs; on meta tensors every lane's kv_len the
    cache's length."""
    b, hq, dh = q.shape
    tot = b * k.shape[1] if kv_len.is_meta else int(kv_len.long().sum())
    return work(b, hq, k.shape[2], dh, tot, q.element_size())


def decode_attention(
    q: torch.Tensor,  # (B, Hq, Dh)
    k: torch.Tensor,  # (B, S, Hkv, Dh)
    v: torch.Tensor,
    kv_len: torch.Tensor,  # (B,) int32, 1 <= kv_len
    *,
    scale: Optional[float] = None,
    logit_cap: float = 0.0,
) -> torch.Tensor:
    """One query token per sequence over its KV cache: (B,Hq,Dh) -> (B,Hq,Dh)."""
    check_local(_K, q=q, k=k, v=v, kv_len=kv_len)
    if op_stats.ACTIVE is not None:
        with op_stats.kernel(_K, lambda: _work_of(q, k, kv_len)):
            if q.is_meta:
                return torch.empty_like(q)
            return op_stats.dense(decode_attention(q, k, v, kv_len, scale=scale,
                                                   logit_cap=logit_cap))
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kv_len, scale=scale, logit_cap=logit_cap)
    check_no_grad(_K, "decode attention serves; training attends through prefill_attention",
                  q=q, k=k, v=v)
    if q.device.type != "cuda":
        raise ValueError(f"{_K}: unsupported device {q.device}")
    if not (q.dim() == 3 and k.dim() == 4):
        raise ValueError(f"{_K}: q must be (B, Hq, Dh), k (B, S, Hkv, Dh)")
    b, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if q.dtype not in DTYPE_CODE:
        raise ValueError(f"{_K}: dtype {q.dtype} not supported")
    if not (k.dtype == q.dtype and v.dtype == q.dtype):
        raise ValueError(f"{_K}: q, k, v dtypes differ")
    if dh not in HEAD_DIMS:
        raise ValueError(f"{_K}: head_dim {dh} not in {HEAD_DIMS}")
    if not (hkv > 0 and hq % hkv == 0 and hq // hkv <= MAX_Q_PER_KV):
        raise ValueError(f"{_K}: Hq={hq}, Hkv={hkv}: need Hq a multiple of Hkv, at most "
                         f"{MAX_Q_PER_KV} query heads per KV head")
    if s < 1:
        raise ValueError(f"{_K}: the cache has no rows (S = 0)")
    check_shape(_K, "k", k, (b, s, hkv, dh))
    check_shape(_K, "v", v, (b, s, hkv, dh))
    check_shape(_K, "kv_len", kv_len, (b,))
    if kv_len.dtype != torch.int32:
        raise ValueError(f"{_K}: kv_len must be int32")
    check_tensors(_K, q.device, ("q", "k", "v"), q=q, k=k, v=v, kv_len=kv_len)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    n_split = -(-s // SPLIT_ROWS)
    # one f32 scratch buffer: the partial accumulators (B, Hq, n_split, Dh),
    # then the partial (m, l) pairs (B, Hq, n_split, 2), 64-byte aligned
    n_acc = b * hq * n_split * dh
    part = torch.empty(n_acc + b * hq * n_split * 2, dtype=torch.float32, device=q.device)
    err = _lib().repro_decode_attention(
        ptr(q), ptr(k), ptr(v), ptr(kv_len), ptr(out), ptr(part), ptr(part) + 4 * n_acc,
        b, s, hq, hkv, dh, n_split, DTYPE_CODE[q.dtype], float(scale), float(logit_cap),
        stream_ptr(q.device),
    )
    if err != 0:
        raise RuntimeError(f"{_K}: kernel launch failed with cudaError {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0  # kernel launches since the last reset
