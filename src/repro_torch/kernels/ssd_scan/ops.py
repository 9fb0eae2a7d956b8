"""Wrapper of the Mamba2 SSD scan kernel (``csrc/ssd_scan.cu``).

Replaces the TPU kernel ``repro.kernels.ssd_scan.kernel.ssd_scan`` and its
layout wrapper ``repro.kernels.ssd_scan.ops.ssd``, with the same sequence
layout and the same chunking (``q = min(chunk, L)``; the kernel masks the
ragged last chunk itself, so nothing is padded here). It also takes an
initial state, so a prefill that continues a cache runs on the kernel too.
On a CPU tensor it calls the plain version (`ref.ssd_chunked`); on a CUDA
tensor it launches the kernel or raises. ngroups = 1: B and C are shared
by every head (the kernel source says more).

Two routes, chosen by `route` from dtype and shape before any launch, a
fixed choice and never a fallback: bf16 at the shapes of `TC_CHUNKS`,
`TC_HEAD_DIMS` and `TC_STATE_DIMS` runs on tensor cores (``ssd_state_pass``
then ``ssd_chunk_out``, with f32 scratch for the state at every chunk start
allocated here); everything else, all of f32 included, runs the scalar
kernel. The tensor-core route rounds the decayed scores, the scaled x of
the state increment and the chunk-start state to bf16
(`ref.ssd_tensor_core_emulation` writes it out), so it is held to
`TC_REL_LIMIT` in relative norm of the plain version in f32.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.checks import (
    DTYPE_CODE,
    check_no_grad,
    check_shape,
    check_tensors,
    ptr,
    require,
    stream_ptr,
)
from repro_torch.kernels.ssd_scan.ref import ssd_chunked

_K = "ssd_scan"
HEAD_DIMS = (16, 32, 64)  # P
STATE_DIMS = (16, 32, 64, 128)  # N
MAX_CHUNK = 128

TENSOR_CORE, SCALAR = "tensor_core", "scalar"
TC_CHUNKS = (64, 128)  # Q: one or two 64-row warpgroups per chunk
TC_HEAD_DIMS = (32, 64)  # P
TC_STATE_DIMS = (32, 64, 128)  # N
# y and the final state of the tensor-core route against the plain version
# in f32 on the same bf16 inputs, ||out - ref|| / ||ref||. chip_smoke.py
# reads at most 2.5e-3 on an H100 over every shape the route takes, so the
# limit is some 2.5 times that, while a dropped diagonal of the scores
# (0.4) or one chunk's state not carried (0.05) at the serving shapes read
# far beyond it.
TC_REL_LIMIT = 6e-3


def route(dtype: torch.dtype, p: int, n: int, q: int) -> str:
    """The kernel that takes a scan of head dim ``p``, state dim ``n`` and
    chunk ``q`` in ``dtype``: `TENSOR_CORE` or `SCALAR`."""
    if dtype == torch.bfloat16 and q in TC_CHUNKS and p in TC_HEAD_DIMS and n in TC_STATE_DIMS:
        return TENSOR_CORE
    return SCALAR


def _lib() -> ctypes.CDLL:
    lib = build.load(_K)
    fn = lib.repro_ssd_scan
    if fn.argtypes is None:
        ptr_t, int_t = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [
            ptr_t, ptr_t, ptr_t, ptr_t, ptr_t, ptr_t,  # x, dt, A, B, C, init_state
            ptr_t, ptr_t, ptr_t,  # y, final_state, S_in scratch (null: scalar kernel)
            int_t, int_t, int_t, int_t, int_t, int_t, int_t,  # B, L, H, P, N, Q, dtype
            ptr_t,  # stream
        ]
        fn.restype = ctypes.c_int
    return lib


def ssd(
    x: torch.Tensor,  # (B, L, H, P)
    dt: torch.Tensor,  # (B, L, H) f32, post-softplus
    A: torch.Tensor,  # (H,) f32, negative
    Bm: torch.Tensor,  # (B, L, N), ngroups = 1
    Cm: torch.Tensor,  # (B, L, N)
    *,
    chunk: int = 128,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N) f32; zeros if None
    kernel: Optional[str] = None,  # `TENSOR_CORE` or `SCALAR`; None: `route`'s choice
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, L, H, P) in x's dtype, final_state (B, H, P, N) f32).
    ``kernel`` forces a route (to time one against the other); a route that
    cannot take the call raises."""
    require(x.dim() == 4 and x.shape[1] >= 1, f"{_K}: x must be (B, L, H, P) with L >= 1")
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    q = min(chunk, l)
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, Bm[:, :, None], Cm[:, :, None], q, init_state)
    check_no_grad(_K, "no backward kernel for the SSD scan yet, ROADMAP A10b: the ssm and "
                  "hybrid families train on the CPU", x=x, dt=dt, A=A, B=Bm, C=Cm,
                  init_state=init_state)
    require(x.device.type == "cuda", f"{_K}: unsupported device {x.device}")
    require(x.dtype in DTYPE_CODE, f"{_K}: dtype {x.dtype} not supported")
    require(Bm.dtype == x.dtype and Cm.dtype == x.dtype, f"{_K}: x, B, C dtypes differ")
    require(dt.dtype == torch.float32 and A.dtype == torch.float32,
            f"{_K}: dt and A must be float32")
    require(p in HEAD_DIMS, f"{_K}: head_dim {p} not in {HEAD_DIMS}")
    require(n in STATE_DIMS, f"{_K}: state_dim {n} not in {STATE_DIMS}")
    require(1 <= chunk <= MAX_CHUNK, f"{_K}: chunk {chunk} not in [1, {MAX_CHUNK}]")
    check_shape(_K, "dt", dt, (b, l, h))
    check_shape(_K, "A", A, (h,))
    check_shape(_K, "B", Bm, (b, l, n))
    check_shape(_K, "C", Cm, (b, l, n))
    tensors = dict(x=x, dt=dt, A=A, B=Bm, C=Cm)
    if init_state is not None:
        check_shape(_K, "init_state", init_state, (b, h, p, n))
        require(init_state.dtype == torch.float32, f"{_K}: init_state must be float32")
        tensors["init_state"] = init_state
    check_tensors(_K, x.device, ("x", "B", "C"), **tensors)
    chosen = route(x.dtype, p, n, chunk)
    kernel = chosen if kernel is None else kernel
    require(kernel in (chosen, SCALAR), f"{_K}: the {kernel} route does not take {x.dtype} at "
            f"P={p} N={n} chunk={chunk}")
    y = torch.empty_like(x)
    final_state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if b * h == 0:
        return y, final_state
    s_in = None
    if kernel == TENSOR_CORE:  # whole chunks of `chunk` rows, the last one ragged
        q = chunk
        s_in = torch.empty((b, -(-l // q), h, p, n), dtype=torch.float32, device=x.device)
    err = _lib().repro_ssd_scan(
        ptr(x), ptr(dt), ptr(A), ptr(Bm), ptr(Cm),
        None if init_state is None else ptr(init_state), ptr(y), ptr(final_state),
        None if s_in is None else ptr(s_in),
        b, l, h, p, n, q, DTYPE_CODE[x.dtype], stream_ptr(x.device),
    )
    if err != 0:
        raise RuntimeError(f"{_K}: kernel launch failed with cudaError {err}")
    ssd.launches += 1
    ssd.route_launches[kernel] += 1
    return y, final_state


ssd.launches = 0  # calls that launched a kernel since the last reset
ssd.route_launches = {TENSOR_CORE: 0, SCALAR: 0}  # the same, by route
