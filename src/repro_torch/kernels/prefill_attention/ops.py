"""Wrapper of the chunked-prefill attention kernel (``csrc/prefill_attention.cu``).

Replaces the TPU kernel ``repro.kernels.prefill_attention.kernel.
flash_prefill_attention`` and its padding wrapper. On a CPU tensor it calls
the plain version (`ref.prefill_attention_ref`); on a CUDA tensor it
launches the kernel or raises. The dtype picks the kernel, a fixed route
and never a fallback: bfloat16 (the serving dtype) runs the tensor-core
kernel (wgmma), float32 (the parity dtype, whose 2e-5 tolerance TF32
tensor cores cannot meet) the scalar f32 kernel. Both are bound by
operations at the serving shapes and mask their ragged edges themselves,
so nothing is padded here (the kernel source says more).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.checks import (
    HEAD_DIMS,
    check_shape,
    check_tensors,
    ptr,
    stream_ptr,
)
from repro_torch.kernels.prefill_attention.ref import prefill_attention_ref

_K = "prefill_attention"


# the kernel of each dtype: bf16 on wgmma, f32 on scalar FMAs
_ENTRY = {torch.bfloat16: "repro_prefill_attention_bf16",
          torch.float32: "repro_prefill_attention_f32"}


def _entry(dtype: torch.dtype):
    fn = getattr(build.load(_K), _ENTRY[dtype])
    if fn.argtypes is None:
        ptr_t, int_t, float_t = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [
            ptr_t, ptr_t, ptr_t, ptr_t, ptr_t, ptr_t,  # q, k, v, q_pos, kv_len, out
            int_t, int_t, int_t, int_t, int_t, int_t,  # B, Sq, Skv, Hq, Hkv, Dh
            float_t, float_t,  # scale, logit cap
            ptr_t,  # stream
        ]
        fn.restype = ctypes.c_int
    return fn


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
    if q.device.type != "cuda":
        raise ValueError(f"{_K}: unsupported device {q.device}")
    if not (q.dim() == 4 and k.dim() == 4):
        raise ValueError(f"{_K}: q and k must be 4-d (B, S, H, Dh)")
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if q.dtype not in _ENTRY:
        raise ValueError(f"{_K}: dtype {q.dtype} not supported")
    if not (k.dtype == q.dtype and v.dtype == q.dtype):
        raise ValueError(f"{_K}: q, k, v dtypes differ")
    if dh not in HEAD_DIMS:
        raise ValueError(f"{_K}: head_dim {dh} not in {HEAD_DIMS}")
    if not (hkv > 0 and hq % hkv == 0):
        raise ValueError(f"{_K}: Hq={hq} is not a multiple of Hkv={hkv}")
    check_shape(_K, "k", k, (b, skv, hkv, dh))
    check_shape(_K, "v", v, (b, skv, hkv, dh))
    check_shape(_K, "q_pos", q_pos, (b, sq))
    check_shape(_K, "kv_len", kv_len, (b,))
    if not (q_pos.dtype == torch.int32 and kv_len.dtype == torch.int32):
        raise ValueError(f"{_K}: q_pos and kv_len must be int32")
    check_tensors(_K, q.device, ("q", "k", "v"), q=q, k=k, v=v, q_pos=q_pos, kv_len=kv_len)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    err = _entry(q.dtype)(
        ptr(q), ptr(k), ptr(v), ptr(q_pos), ptr(kv_len), ptr(out),
        b, sq, skv, hq, hkv, dh, float(scale), float(logit_cap), stream_ptr(q.device),
    )
    if err != 0:
        raise RuntimeError(f"{_K}: kernel launch failed with cudaError {err}")
    prefill_attention.launches += 1
    return out


prefill_attention.launches = 0  # kernel launches since the last reset
