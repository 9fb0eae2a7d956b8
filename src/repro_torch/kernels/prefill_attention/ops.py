"""Wrappers of the chunked-prefill attention kernels (``csrc/prefill_attention.cu``
and its backward, ``csrc/prefill_attention_bwd.cu``).

Replaces the TPU kernel ``repro.kernels.prefill_attention.kernel.
flash_prefill_attention`` and its padding wrapper. On a CPU tensor each
wrapper calls its plain version (`ref`); on a CUDA tensor it launches the
kernel or raises. The dtype picks the forward kernel, a fixed route and
never a fallback: bfloat16 (the serving and training dtype) runs the
tensor-core kernel (wgmma), float32 (the parity dtype, whose 2e-5
tolerance TF32 tensor cores cannot meet) the scalar f32 kernel. Both are
bound by operations at the serving shapes and mask their ragged edges
themselves, so nothing is padded here (the kernel source says more).

Gradients: `prefill_attention` goes through `PrefillAttentionFn` when grad
mode is on and q, k or v requires grad. Its forward has the forward kernel
write the row log-sum-exp beside the output, and its backward launches the
backward kernels (`prefill_attention_bwd`; bf16 on wgmma, f32 on scalar
FMAs, chosen by dtype as the forward's) on CUDA tensors and runs their
plain version, `ref.prefill_attention_bwd_ref`, on CPU tensors. The
serving path (no grad) passes no log-sum-exp and launches exactly what it
did before. The reference cannot differentiate its Pallas kernel at all
(``pallas_call`` has no transpose rule) and trains on its plain attention;
this is the port's counterpart of XLA's autodiff there.

`work` and `bwd_work` are the operations and bytes of one call, what the
kernels' bounds count (`roofline.analysis.bound`); while a count of
`roofline.op_stats` is active each wrapper adds its work and runs its own
path uncounted.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.checks import (
    HEAD_DIMS,
    check_local,
    check_no_grad,
    check_shape,
    check_tensors,
    ptr,
    stream_ptr,
)
from repro_torch.kernels.prefill_attention.ref import (
    prefill_attention_bwd_ref,
    prefill_attention_lse,
    prefill_attention_ref,
)
from repro_torch.roofline import op_stats

_K = "prefill_attention"
_KB = "prefill_attention_bwd"


# the forward kernel of each dtype: bf16 on wgmma, f32 on scalar FMAs
_ENTRY = {torch.bfloat16: "repro_prefill_attention_bf16",
          torch.float32: "repro_prefill_attention_f32"}
# the backward kernels of each dtype, a fixed route as the forward's: bf16 on
# wgmma (dK/dV and dQ in two deterministic passes, P and dS rounded to bf16 as
# the products' operands), f32 on the scalar kernels (f32 FMAs, the 2e-5
# tolerance); the kernel source says what bounds each
_BWD_ENTRY = {torch.bfloat16: "repro_prefill_attention_bwd_bf16",
              torch.float32: "repro_prefill_attention_bwd_f32"}


def visible_rows(q_pos: torch.Tensor, kv_len: torch.Tensor, skv: int) -> Tuple[int, int]:
    """(visible, kv_rows): the (query, key) pairs a call attends over, and
    the K/V rows it reads, from the data; on meta tensors (no data) the
    canonical layout, every kv_len ``skv`` and the chunk at its end."""
    if q_pos.is_meta:
        b, sq = q_pos.shape
        return b * (sq * (skv - sq) + sq * (sq + 1) // 2), b * skv
    visible = int(torch.minimum(q_pos.long() + 1, kv_len.long()[:, None]).sum())
    kv_rows = int(torch.minimum(q_pos.long().amax(1) + 1, kv_len.long()).sum())
    return visible, kv_rows


def work(b: int, sq: int, hq: int, hkv: int, dh: int, visible: int, kv_rows: int,
         esize: int = 2) -> Tuple[int, int]:
    """(operations, bytes) of one forward call: 4 Hq Dh per visible pair
    (q.k and p.v); q and the output, the K and V rows read, once each, in
    elements of ``esize`` bytes, and q_pos and kv_len."""
    flops = 4 * hq * dh * visible
    nbytes = esize * (2 * b * sq * hq * dh + 2 * kv_rows * hkv * dh) + 4 * (b * sq + b)
    return flops, nbytes


def bwd_work(b: int, sq: int, skv: int, hq: int, hkv: int, dh: int, visible: int,
             esize: int = 2) -> Tuple[int, int]:
    """(operations, bytes) of one backward call: 5 products of 2 Hq Dh per
    visible pair (S, dP, dV, dK, dQ); q, out, dO and dq, k, v, dk and dv
    once each, the f32 log-sum-exp, q_pos and kv_len."""
    flops = 5 * 2 * hq * dh * visible
    nbytes = (esize * (4 * b * sq * hq * dh + 4 * b * skv * hkv * dh) + 4 * b * hq * sq
              + 4 * (b * sq + b))
    return flops, nbytes


def _work_of(q, k, q_pos, kv_len) -> Tuple[int, int]:
    b, sq, hq, dh = q.shape
    return work(b, sq, hq, k.shape[2], dh, *visible_rows(q_pos, kv_len, k.shape[1]),
                q.element_size())


def _entry(dtype: torch.dtype):
    fn = getattr(build.load(_K), _ENTRY[dtype])
    if fn.argtypes is None:
        ptr_t, int_t, float_t = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [
            ptr_t, ptr_t, ptr_t, ptr_t, ptr_t, ptr_t,  # q, k, v, q_pos, kv_len, out
            ptr_t,  # lse (B, Hq, Sq) f32, or null
            int_t, int_t, int_t, int_t, int_t, int_t,  # B, Sq, Skv, Hq, Hkv, Dh
            float_t, float_t,  # scale, logit cap
            ptr_t,  # stream
        ]
        fn.restype = ctypes.c_int
    return fn


def _bwd_entry(dtype: torch.dtype):
    fn = getattr(build.load(_KB), _BWD_ENTRY[dtype])
    if fn.argtypes is None:
        ptr_t, int_t, float_t = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [
            ptr_t, ptr_t, ptr_t, ptr_t, ptr_t, ptr_t,  # q, k, v, out, dout, lse
            ptr_t, ptr_t,  # q_pos, kv_len
            ptr_t, ptr_t, ptr_t, ptr_t,  # dq, dk, dv, D scratch
            int_t, int_t, int_t, int_t, int_t, int_t,  # B, Sq, Skv, Hq, Hkv, Dh
            float_t, float_t,  # scale, logit cap
            ptr_t,  # stream
        ]
        fn.restype = ctypes.c_int
    return fn


def _check_args(kernel: str, q, k, v, q_pos, kv_len) -> Tuple[int, int, int, int, int, int]:
    """What both kernels assume of q, k, v, q_pos and kv_len on the card;
    returns (B, Sq, Skv, Hq, Hkv, Dh)."""
    if q.device.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {q.device}")
    if not (q.dim() == 4 and k.dim() == 4):
        raise ValueError(f"{kernel}: q and k must be 4-d (B, S, H, Dh)")
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if q.dtype not in _ENTRY:
        raise ValueError(f"{kernel}: dtype {q.dtype} not supported")
    if not (k.dtype == q.dtype and v.dtype == q.dtype):
        raise ValueError(f"{kernel}: q, k, v dtypes differ")
    if dh not in HEAD_DIMS:
        raise ValueError(f"{kernel}: head_dim {dh} not in {HEAD_DIMS}")
    if not (hkv > 0 and hq % hkv == 0):
        raise ValueError(f"{kernel}: Hq={hq} is not a multiple of Hkv={hkv}")
    check_shape(kernel, "k", k, (b, skv, hkv, dh))
    check_shape(kernel, "v", v, (b, skv, hkv, dh))
    check_shape(kernel, "q_pos", q_pos, (b, sq))
    check_shape(kernel, "kv_len", kv_len, (b,))
    if not (q_pos.dtype == torch.int32 and kv_len.dtype == torch.int32):
        raise ValueError(f"{kernel}: q_pos and kv_len must be int32")
    check_tensors(kernel, q.device, ("q", "k", "v"), q=q, k=k, v=v, q_pos=q_pos, kv_len=kv_len)
    return b, sq, skv, hq, hkv, dh


def _forward(q, k, v, q_pos, kv_len, scale, logit_cap, with_lse: bool):
    """Launch the forward kernel: (out, lse (B, Hq, Sq) f32 or None)."""
    check_no_grad(_K, "prefill_attention takes PrefillAttentionFn when grad is needed",
                  q=q, k=k, v=v)
    b, sq, skv, hq, hkv, dh = _check_args(_K, q, k, v, q_pos, kv_len)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if with_lse else None
    if out.numel() == 0:
        return out, lse
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    err = _entry(q.dtype)(
        ptr(q), ptr(k), ptr(v), ptr(q_pos), ptr(kv_len), ptr(out),
        None if lse is None else ptr(lse),
        b, sq, skv, hq, hkv, dh, float(scale), float(logit_cap), stream_ptr(q.device),
    )
    if err != 0:
        raise RuntimeError(f"{_K}: kernel launch failed with cudaError {err}")
    prefill_attention.launches += 1
    return out, lse


def prefill_attention_bwd(
    q: torch.Tensor,  # (B, Sq, Hq, Dh)
    k: torch.Tensor,  # (B, Skv, Hkv, Dh)
    v: torch.Tensor,
    out: torch.Tensor,  # (B, Sq, Hq, Dh), the forward's output
    lse: torch.Tensor,  # (B, Hq, Sq) f32, the forward's log-sum-exp
    dout: torch.Tensor,  # (B, Sq, Hq, Dh)
    q_pos: torch.Tensor,
    kv_len: torch.Tensor,
    *,
    scale: Optional[float] = None,
    logit_cap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `prefill_attention` at these inputs, given the
    forward's ``out`` and ``lse``: the backward kernels (one C call, three
    launches: D = rowsum(dO * O), dK and dV, dQ), or their plain version on
    CPU tensors. Counts one launch per call."""
    check_local(_KB, q=q, k=k, v=v, out=out, lse=lse, dout=dout, q_pos=q_pos,
                kv_len=kv_len)
    if op_stats.ACTIVE is not None:
        b, sq, hq, dh = q.shape
        skv = k.shape[1]
        with op_stats.kernel(_KB, lambda: bwd_work(
                b, sq, skv, hq, k.shape[2], dh, visible_rows(q_pos, kv_len, skv)[0],
                q.element_size())):
            if q.is_meta:
                return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
            return op_stats.dense(prefill_attention_bwd(
                q, k, v, out, lse, dout, q_pos, kv_len, scale=scale, logit_cap=logit_cap))
    if q.device.type == "cpu":
        return prefill_attention_bwd_ref(q, k, v, out, lse, dout, q_pos, kv_len, scale=scale,
                                         logit_cap=logit_cap)
    check_no_grad(_KB, "the backward has no gradient of its own: no double backward",
                  q=q, k=k, v=v, out=out, lse=lse, dout=dout)
    b, sq, skv, hq, hkv, dh = _check_args(_KB, q, k, v, q_pos, kv_len)
    check_shape(_KB, "out", out, q.shape)
    check_shape(_KB, "dout", dout, q.shape)
    check_shape(_KB, "lse", lse, (b, hq, sq))
    if not (out.dtype == q.dtype and dout.dtype == q.dtype and lse.dtype == torch.float32):
        raise ValueError(f"{_KB}: out and dout must have q's dtype, lse float32")
    check_tensors(_KB, q.device, ("out", "dout"), out=out, dout=dout, lse=lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    d_scratch = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    err = _bwd_entry(q.dtype)(
        ptr(q), ptr(k), ptr(v), ptr(out), ptr(dout), ptr(lse), ptr(q_pos), ptr(kv_len),
        ptr(dq), ptr(dk), ptr(dv), ptr(d_scratch),
        b, sq, skv, hq, hkv, dh, float(scale), float(logit_cap), stream_ptr(q.device),
    )
    if err != 0:
        raise RuntimeError(f"{_KB}: kernel launch failed with cudaError {err}")
    prefill_attention_bwd.launches += 1
    return dq, dk, dv


def prefill_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor,
    kv_len: torch.Tensor, *, scale: Optional[float] = None, logit_cap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse (B, Hq, Sq) f32): the forward `PrefillAttentionFn` saves for
    its backward, the forward kernel writing the row log-sum-exp beside the
    output on a CUDA tensor, the plain versions on a CPU tensor."""
    check_local(_K, q=q, k=k, v=v, q_pos=q_pos, kv_len=kv_len)
    if op_stats.ACTIVE is not None:
        with op_stats.kernel(_K, lambda: _work_of(q, k, q_pos, kv_len)):
            if q.is_meta:
                return torch.empty_like(q), q.new_empty(
                    (q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32)
            return op_stats.dense(prefill_attention_fwd(q, k, v, q_pos, kv_len, scale=scale,
                                                        logit_cap=logit_cap))
    if q.device.type == "cpu":
        return (prefill_attention_ref(q, k, v, q_pos, kv_len, scale=scale, logit_cap=logit_cap),
                prefill_attention_lse(q, k, q_pos, kv_len, scale=scale, logit_cap=logit_cap))
    return _forward(q, k, v, q_pos, kv_len, scale, logit_cap, with_lse=True)


class PrefillAttentionFn(torch.autograd.Function):
    """`prefill_attention` with its gradient: the forward kernel (writing the
    row log-sum-exp) and the backward kernels on CUDA tensors, the plain
    versions on CPU tensors. Gradients flow to q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_len, scale, logit_cap):
        out, lse = prefill_attention_fwd(q, k, v, q_pos, kv_len, scale=scale,
                                         logit_cap=logit_cap)
        ctx.save_for_backward(q, k, v, out, lse, q_pos, kv_len)
        ctx.scale, ctx.logit_cap = scale, logit_cap
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, q_pos, kv_len = ctx.saved_tensors
        dq, dk, dv = prefill_attention_bwd(q, k, v, out, lse, dout.contiguous(), q_pos, kv_len,
                                           scale=ctx.scale, logit_cap=ctx.logit_cap)
        return dq, dk, dv, None, None, None, None


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
    (B,Sq,Hq,Dh) x (B,Skv,Hkv,Dh) -> (B,Sq,Hq,Dh); differentiable in q, k
    and v through `PrefillAttentionFn`."""
    check_local(_K, q=q, k=k, v=v, q_pos=q_pos, kv_len=kv_len)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return PrefillAttentionFn.apply(q, k, v, q_pos, kv_len, scale, logit_cap)
    if op_stats.ACTIVE is not None:
        with op_stats.kernel(_K, lambda: _work_of(q, k, q_pos, kv_len)):
            if q.is_meta:
                return torch.empty_like(q)
            return op_stats.dense(prefill_attention(q, k, v, q_pos, kv_len, scale=scale,
                                                    logit_cap=logit_cap))
    if q.device.type == "cpu":
        return prefill_attention_ref(q, k, v, q_pos, kv_len, scale=scale, logit_cap=logit_cap)
    return _forward(q, k, v, q_pos, kv_len, scale, logit_cap, with_lse=False)[0]


prefill_attention.launches = 0  # forward kernel launches since the last reset
prefill_attention_bwd.launches = 0  # backward calls (three kernels each) since the last reset
