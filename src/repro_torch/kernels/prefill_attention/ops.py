"""Wrapper of the chunked-prefill attention kernel (``csrc/prefill_attention.cu``).

Replaces the TPU kernel ``repro.kernels.prefill_attention.kernel.
flash_prefill_attention`` and its padding wrapper. On a CPU tensor it calls
the plain version (`ref.prefill_attention_ref`); on a CUDA tensor it
launches the kernel or raises. The kernel is bound by operations at the
serving shapes and masks its ragged edges itself, so nothing is padded
here (the kernel source says more).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.checks import (
    DTYPE_CODE,
    HEAD_DIMS,
    check_shape,
    check_tensors,
    ptr,
    require,
    stream_ptr,
)
from repro_torch.kernels.prefill_attention.ref import prefill_attention_ref

_K = "prefill_attention"


def _lib() -> ctypes.CDLL:
    lib = build.load(_K)
    fn = lib.repro_prefill_attention
    if fn.argtypes is None:
        ptr_t, int_t, float_t = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [
            ptr_t, ptr_t, ptr_t, ptr_t, ptr_t, ptr_t,  # q, k, v, q_pos, kv_len, out
            int_t, int_t, int_t, int_t, int_t, int_t, int_t,  # B, Sq, Skv, Hq, Hkv, Dh, dtype
            float_t, float_t,  # scale, logit cap
            ptr_t,  # stream
        ]
        fn.restype = ctypes.c_int
    return lib


def prefill_attention(
    q: torch.Tensor,  # (B, Sq, Hq, Dh)
    k: torch.Tensor,  # (B, Skv, Hkv, Dh)
    v: torch.Tensor,
    q_pos: torch.Tensor,  # (B, Sq) int32 absolute positions
    kv_len: torch.Tensor,  # (B,) int32 valid prefix, >= 1
    *,
    scale: Optional[float] = None,
    logit_cap: float = 0.0,
) -> torch.Tensor:
    """Causal GQA attention of a query chunk over a KV prefix:
    (B,Sq,Hq,Dh) x (B,Skv,Hkv,Dh) -> (B,Sq,Hq,Dh)."""
    if q.device.type == "cpu":
        return prefill_attention_ref(q, k, v, q_pos, kv_len, scale=scale, logit_cap=logit_cap)
    require(q.device.type == "cuda", f"{_K}: unsupported device {q.device}")
    require(q.dim() == 4 and k.dim() == 4, f"{_K}: q and k must be 4-d (B, S, H, Dh)")
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    require(q.dtype in DTYPE_CODE, f"{_K}: dtype {q.dtype} not supported")
    require(k.dtype == q.dtype and v.dtype == q.dtype, f"{_K}: q, k, v dtypes differ")
    require(dh in HEAD_DIMS, f"{_K}: head_dim {dh} not in {HEAD_DIMS}")
    require(hkv > 0 and hq % hkv == 0, f"{_K}: Hq={hq} is not a multiple of Hkv={hkv}")
    check_shape(_K, "k", k, (b, skv, hkv, dh))
    check_shape(_K, "v", v, (b, skv, hkv, dh))
    check_shape(_K, "q_pos", q_pos, (b, sq))
    check_shape(_K, "kv_len", kv_len, (b,))
    require(q_pos.dtype == torch.int32 and kv_len.dtype == torch.int32,
            f"{_K}: q_pos and kv_len must be int32")
    check_tensors(_K, q.device, ("q", "k", "v"), q=q, k=k, v=v, q_pos=q_pos, kv_len=kv_len)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    err = _lib().repro_prefill_attention(
        ptr(q), ptr(k), ptr(v), ptr(q_pos), ptr(kv_len), ptr(out),
        b, sq, skv, hq, hkv, dh, DTYPE_CODE[q.dtype], float(scale), float(logit_cap),
        stream_ptr(q.device),
    )
    if err != 0:
        raise RuntimeError(f"{_K}: kernel launch failed with cudaError {err}")
    prefill_attention.launches += 1
    return out


prefill_attention.launches = 0  # kernel launches since the last reset
