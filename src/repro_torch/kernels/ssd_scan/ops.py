"""Wrapper of the Mamba2 SSD scan kernel (``csrc/ssd_scan.cu``).

Replaces the TPU kernel ``repro.kernels.ssd_scan.kernel.ssd_scan`` and its
layout wrapper ``repro.kernels.ssd_scan.ops.ssd``, with the same sequence
layout and the same chunking (``q = min(chunk, L)``; the kernel masks the
ragged last chunk itself, so nothing is padded here). It also takes an
initial state, so a prefill that continues a cache runs on the kernel too.
On a CPU tensor it calls the plain version (`ref.ssd_chunked`); on a CUDA
tensor it launches the kernel or raises. B and C come in G groups,
(B, L, G, N), or (B, L, N) for one group: head h reads group h // (H // G),
as the reference's ``ssd_chunked`` repeats the groups over the heads, and
their gradients are summed over each group's heads. The kernels' chunk
blocks take heads of one group (`_head_group`, the kernel source says
more).

Two routes, chosen by `route` from dtype and shape before any launch, a
fixed choice and never a fallback: bf16 at the shapes of `TC_CHUNKS`,
`TC_HEAD_DIMS` and `TC_STATE_DIMS` runs on tensor cores (``ssd_state_pass``
then ``ssd_chunk_out``, with f32 scratch for the state at every chunk start
allocated here); everything else, all of f32 included, runs the scalar
kernel. The tensor-core route rounds the decayed scores, the scaled x of
the state increment and the chunk-start state to bf16
(`ref.ssd_tensor_core_emulation` writes it out), so it is held to
`TC_REL_LIMIT` in relative norm of the plain version in f32.

Gradients: `ssd` goes through `SSDScanFn` when grad mode is on and any of
x, dt, A, B, C or the initial state requires grad. Its forward runs the
same route, which also writes the state at every chunk start (``S_in``,
f32) for the backward; its backward launches the backward kernels
(`ssd_bwd`, ``csrc/ssd_scan_bwd.cu``) on CUDA tensors and runs their plain
version, `ref.ssd_chunked_bwd`, on CPU tensors, and never re-runs the
sequential forward pass. The backward has the same two routes, chosen by
`route` at its own chunk ``min(chunk, L)``: bf16 at the route's shapes on
tensor cores (``ssd_state_bwd_wgmma``, ``ssd_chunk_bwd_wgmma``, rounding as
`ref.ssd_tensor_core_bwd_emulation` writes out), everything else on the
scalar kernels. The serving path (no grad) launches exactly what
it did before. The reference trains on its plain scan under XLA's
autodiff (its Pallas kernel has no gradient); this is the port's
counterpart. On a CPU tensor `ssd` itself stays the plain version under
autograd.

`work` and `bwd_work` are the operations and bytes of one call, what the
kernels' bounds count (`roofline.analysis.bound`); while a count of
`roofline.op_stats` is active each wrapper adds its work and runs its own
path uncounted, and `ssd` under grad takes `SSDScanFn` on every device, so
that its backward is counted as the backward kernels.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.checks import (
    DTYPE_CODE,
    check_local,
    check_no_grad,
    check_shape,
    check_tensors,
    ptr,
    require,
    stream_ptr,
)
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_chunked_bwd
from repro_torch.roofline import op_stats

_K = "ssd_scan"
_KB = "ssd_scan_bwd"
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
# The bf16 backward (dx, ddt, dA, dB, dC, dinit) against the plain backward in
# f32 from the exact states on the same bf16 inputs, ||out - ref|| / ||ref||
# of each, on either route. The state at each chunk start comes from the
# forward's tensor-core route, its increments rounded to bf16
# (`ref.ssd_tensor_core_states`). The scalar kernels widen bf16 to f32 and
# round only dx, dB and dC: with those states some 2e-3 to 4e-3. The
# tensor-core route also rounds to bf16 the operands of its products: exp(cums)
# dy in the state pass, M = G E and dG, and dS and S as the state operands
# (`ref.ssd_tensor_core_bwd_emulation`; every sum that feeds ddt, dA and
# dcums stays f32): the emulation reads at most 2.4e-3 in
# tests/test_torch_ssd_grad.py, the kernels at most 4.0e-3 over
# chip_smoke.py's sweep on an H100. chip_smoke.py plants two faults in the plain
# backward (dS not carried across one chunk; the reverse cumsum of dcums
# dropped), which must land beyond twice this limit.
SSD_BWD_BF16_REL = 1e-2
_HG_MAX = 8  # heads per ssd_chunk_bwd block, at most (the tensor-core kernel's HG_MAX)
_sms: dict = {}  # SM count per card


def _chunk_rows(l: int, chunk: int):
    q = min(chunk, l)
    return [q] * (l // q) + ([l % q] if l % q else [])


def work(b: int, l: int, h: int, p: int, n: int, chunk: int, esize: int,
         g: int = 1) -> Tuple[int, int]:
    """(operations, bytes) of one SSD scan with ``g`` groups of B and C: per
    (batch, head, chunk of q rows) 2 q^2 N (C B^T) + 2 q^2 P (scores . x dt)
    + 2 q N P (C state^T) + 2 q P N (state increment); x and y, dt, B and C
    (each group) once, the final state."""
    rows = _chunk_rows(l, chunk)
    flops = b * h * sum(2 * r * r * (n + p) + 4 * r * n * p for r in rows)
    nbytes = esize * (2 * b * l * h * p + 2 * b * l * g * n) + 4 * (b * l * h + h + b * h * p * n)
    return flops, nbytes


def bwd_work(b: int, l: int, h: int, p: int, n: int, chunk: int, esize: int,
             g: int = 1) -> Tuple[int, int]:
    """(operations, bytes) of one SSD backward with ``g`` groups of B and C:
    per (batch, head, chunk of q rows) 2 q^2 (2 P + 3 N) (G, dy.x^T, M^T dy,
    dG B, dG^T C) + 8 q P N (the four state products); x, dy and dx, S_in
    (f32, one state per chunk), dt and ddt, A and dA, B, C, dB and dC (each
    group) once, as training calls it (no initial state, the final state
    unused)."""
    rows = _chunk_rows(l, chunk)
    flops = b * h * sum(2 * r * r * (2 * p + 3 * n) + 8 * r * p * n for r in rows)
    nbytes = (esize * (3 * b * l * h * p + 4 * b * l * g * n) + 4 * b * len(rows) * h * p * n
              + 4 * (2 * b * l * h + 2 * h))
    return flops, nbytes


def _groups(Bm) -> int:
    """G of B or C given as (B, L, G, N), or (B, L, N) for one group."""
    return Bm.shape[2] if Bm.dim() == 4 else 1


def _check_layout(kernel: str, x, Bm, Cm) -> None:
    """x is (B, L, H, P) with L >= 1; B and C have one shape, (B, L, G, N)
    with H a multiple of G or (B, L, N): on every device."""
    require(x.dim() == 4 and x.shape[1] >= 1, f"{kernel}: x must be (B, L, H, P) with L >= 1")
    require(Bm.dim() in (3, 4) and Bm.shape == Cm.shape,
            f"{kernel}: B and C must both be (B, L, G, N) or (B, L, N), got {tuple(Bm.shape)} "
            f"and {tuple(Cm.shape)}")
    require(x.shape[2] % _groups(Bm) == 0,
            f"{kernel}: {x.shape[2]} heads do not divide into {_groups(Bm)} groups of B and C")


def _work_args(x, Bm, chunk):
    b, l, h, p = x.shape
    return b, l, h, p, Bm.shape[-1], chunk, x.element_size(), _groups(Bm)


def route(dtype: torch.dtype, p: int, n: int, q: int) -> str:
    """The kernel that takes a scan of head dim ``p``, state dim ``n`` and
    chunk ``q`` in ``dtype``: `TENSOR_CORE` or `SCALAR`."""
    if dtype == torch.bfloat16 and q in TC_CHUNKS and p in TC_HEAD_DIMS and n in TC_STATE_DIMS:
        return TENSOR_CORE
    return SCALAR


_ROUTE_CODE = {SCALAR: 0, TENSOR_CORE: 1}


def _lib() -> ctypes.CDLL:
    lib = build.load(_K)
    fn = lib.repro_ssd_scan
    if fn.argtypes is None:
        ptr_t, int_t = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [
            ptr_t, ptr_t, ptr_t, ptr_t, ptr_t, ptr_t,  # x, dt, A, B, C, init_state
            ptr_t, ptr_t, ptr_t,  # y, final_state, S_in (the tensor-core route's scratch, or null)
            int_t, int_t, int_t, int_t, int_t, int_t,  # B, L, H, G, P, N
            int_t, int_t, int_t, ptr_t,  # Q, dtype, route, stream
        ]
        fn.restype = ctypes.c_int
    return lib


def _bwd_fn():
    fn = build.load(_KB).repro_ssd_scan_bwd
    if fn.argtypes is None:
        ptr_t, int_t = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [
            ptr_t, ptr_t, ptr_t, ptr_t, ptr_t, ptr_t, ptr_t, ptr_t,  # x, dt, A, B, C, dy, S_in, dfinal
            ptr_t, ptr_t, ptr_t, ptr_t, ptr_t, ptr_t,  # dx, ddt, dA, dB, dC, dinit (or null)
            ptr_t, ptr_t, ptr_t, ptr_t,  # scratch: dS at chunk ends, dB, dC, dA partials
            int_t, int_t, int_t, int_t, int_t, int_t,  # B, L, H, G, P, N
            int_t, int_t, int_t, int_t, ptr_t,  # Q, hg, dtype, route, stream
        ]
        fn.restype = ctypes.c_int
    return fn


def bwd_route(dtype: torch.dtype, p: int, n: int, chunk: int, l: int,
              kernel: Optional[str] = None) -> str:
    """The route of `ssd_bwd` at its chunk ``min(chunk, l)``: ``kernel`` where
    given (`SCALAR` takes every call; `TENSOR_CORE` only what `route`
    gives it, else this raises), else `route`'s choice."""
    chosen = route(dtype, p, n, min(chunk, l))
    kernel = chosen if kernel is None else kernel
    require(kernel in (chosen, SCALAR), f"{_KB}: the {kernel} route does not take {dtype} at "
            f"P={p} N={n} chunk={min(chunk, l)}")
    return kernel


def _head_group(h: int, g: int, nc: int, b: int, device: torch.device) -> int:
    """Heads per ``ssd_chunk_bwd`` block, all of one group: `_HG_MAX`,
    halved while the grid of ``g`` ceil(rep / HG) x ``nc`` x ``b`` blocks
    would leave SMs without a block, then at most rep = h / g (the rule of
    the forward's ``ssd_chunk_out`` in ``csrc/ssd_scan.cu``). At g = 1 it is
    the one-group grid of ceil(h / HG) blocks per chunk."""
    sms = _sms.get(device.index)
    if sms is None:
        sms = _sms[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    rep = h // g
    hg = _HG_MAX
    while hg > 1 and g * -(-rep // hg) * nc * b < sms:
        hg //= 2
    return min(hg, rep)


def _check_args(kernel: str, x, dt, A, Bm, Cm, chunk) -> Tuple[int, int, int, int, int, int]:
    """What the forward and backward kernels assume of x, dt, A, B, C and
    the chunk on the card; returns (B, L, H, P, N, G)."""
    b, l, h, p = x.shape
    n, g = Bm.shape[-1], _groups(Bm)
    require(x.device.type == "cuda", f"{kernel}: unsupported device {x.device}")
    require(x.dtype in DTYPE_CODE, f"{kernel}: dtype {x.dtype} not supported")
    require(Bm.dtype == x.dtype and Cm.dtype == x.dtype, f"{kernel}: x, B, C dtypes differ")
    require(dt.dtype == torch.float32 and A.dtype == torch.float32,
            f"{kernel}: dt and A must be float32")
    require(p in HEAD_DIMS, f"{kernel}: head_dim {p} not in {HEAD_DIMS}")
    require(n in STATE_DIMS, f"{kernel}: state_dim {n} not in {STATE_DIMS}")
    require(1 <= chunk <= MAX_CHUNK, f"{kernel}: chunk {chunk} not in [1, {MAX_CHUNK}]")
    check_shape(kernel, "dt", dt, (b, l, h))
    check_shape(kernel, "A", A, (h,))
    bc = (b, l, g, n) if Bm.dim() == 4 else (b, l, n)
    check_shape(kernel, "B", Bm, bc)
    check_shape(kernel, "C", Cm, bc)
    check_tensors(kernel, x.device, ("x", "B", "C"), x=x, dt=dt, A=A, B=Bm, C=Cm)
    return b, l, h, p, n, g


def _forward(x, dt, A, Bm, Cm, chunk, init_state, kernel, with_s_in):
    """Launch the forward kernels: (y, final_state, S_in (B, NC, H, P, N)
    f32 or None), S_in written where ``with_s_in`` (the tensor-core route
    takes it as its scratch either way)."""
    check_no_grad(_K, "ssd takes SSDScanFn when grad is needed", x=x, dt=dt, A=A, B=Bm, C=Cm,
                  init_state=init_state)
    b, l, h, p, n, g = _check_args(_K, x, dt, A, Bm, Cm, chunk)
    if init_state is not None:
        check_shape(_K, "init_state", init_state, (b, h, p, n))
        require(init_state.dtype == torch.float32, f"{_K}: init_state must be float32")
        check_tensors(_K, x.device, (), init_state=init_state)
    chosen = route(x.dtype, p, n, chunk)
    kernel = chosen if kernel is None else kernel
    require(kernel in (chosen, SCALAR), f"{_K}: the {kernel} route does not take {x.dtype} at "
            f"P={p} N={n} chunk={chunk}")
    # the scalar kernel takes chunks of min(chunk, L); the tensor-core route
    # whole chunks of `chunk` rows, the last one ragged: the same chunks
    q = chunk if kernel == TENSOR_CORE else min(chunk, l)
    y = torch.empty_like(x)
    final_state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    s_in = None
    if kernel == TENSOR_CORE or with_s_in:
        s_in = torch.empty((b, -(-l // q), h, p, n), dtype=torch.float32, device=x.device)
    if b * h == 0:
        return y, final_state, s_in
    err = _lib().repro_ssd_scan(
        ptr(x), ptr(dt), ptr(A), ptr(Bm), ptr(Cm),
        None if init_state is None else ptr(init_state), ptr(y), ptr(final_state),
        None if s_in is None else ptr(s_in),
        b, l, h, g, p, n, q, DTYPE_CODE[x.dtype], _ROUTE_CODE[kernel], stream_ptr(x.device),
    )
    if err != 0:
        raise RuntimeError(f"{_K}: kernel launch failed with cudaError {err}")
    ssd.launches += 1
    ssd.route_launches[kernel] += 1
    return y, final_state, s_in


def ssd_bwd(
    x: torch.Tensor,  # (B, L, H, P)
    dt: torch.Tensor,  # (B, L, H) f32
    A: torch.Tensor,  # (H,) f32
    Bm: torch.Tensor,  # (B, L, G, N), or (B, L, N): one group
    Cm: torch.Tensor,  # as Bm
    s_in: Optional[torch.Tensor],  # (B, NC, H, P, N) f32, the forward's; None on the CPU recomputes it
    dy: torch.Tensor,  # (B, L, H, P), x's dtype
    dfinal: Optional[torch.Tensor] = None,  # (B, H, P, N) f32; None: the final state unused
    *,
    chunk: int = 128,
    init_state: Optional[torch.Tensor] = None,  # the forward's, read only to recompute S_in
    with_dinit: bool = True,
    kernel: Optional[str] = None,  # `TENSOR_CORE` or `SCALAR`; None: `bwd_route`'s choice
) -> Tuple[torch.Tensor, ...]:
    """(dx, ddt, dA, dB, dC, dinit) of `ssd` at these inputs, given the
    forward's ``s_in``: the backward kernels of the route `bwd_route` picks
    (one C call, three launches: ``ssd_state_bwd``, ``ssd_chunk_bwd`` and
    ``ssd_bwd_reduce``, with ``_wgmma`` on the tensor-core route), or their
    plain version on CPU tensors. dB and dC have B's and C's shapes, each
    group's summed over its heads; dinit is None unless ``with_dinit``.
    ``kernel`` forces a route (to time one against the other). Counts one
    launch per call."""
    check_local(_KB, x=x, dt=dt, A=A, Bm=Bm, Cm=Cm, s_in=s_in, dy=dy, dfinal=dfinal,
                init_state=init_state)
    _check_layout(_KB, x, Bm, Cm)
    b, l, h, p = x.shape
    if op_stats.ACTIVE is not None:
        with op_stats.kernel(_KB, lambda: bwd_work(*_work_args(x, Bm, chunk))):
            if x.is_meta:
                f32 = dict(dtype=torch.float32)
                return (torch.empty_like(x), x.new_empty((b, l, h), **f32),
                        x.new_empty((h,), **f32), torch.empty_like(Bm), torch.empty_like(Cm),
                        x.new_empty((b, h, p, Bm.shape[-1]), **f32) if with_dinit else None)
            return op_stats.dense(ssd_bwd(x, dt, A, Bm, Cm, s_in, dy, dfinal, chunk=chunk,
                                          init_state=init_state, with_dinit=with_dinit,
                                          kernel=kernel))
    q = min(chunk, l)
    if x.device.type == "cpu":
        out = ssd_chunked_bwd(x, dt, A, Bm, Cm, q, init_state, s_in, dy, dfinal)
        return out if with_dinit else (*out[:5], None)
    check_no_grad(_KB, "the backward has no gradient of its own: no double backward",
                  x=x, dt=dt, A=A, B=Bm, C=Cm, s_in=s_in, dy=dy, dfinal=dfinal)
    b, l, h, p, n, g = _check_args(_KB, x, dt, A, Bm, Cm, chunk)
    kernel = bwd_route(x.dtype, p, n, chunk, l, kernel)
    nc = -(-l // q)
    require(s_in is not None, f"{_KB}: s_in, the forward's state at every chunk start, is needed")
    check_shape(_KB, "s_in", s_in, (b, nc, h, p, n))
    check_shape(_KB, "dy", dy, (b, l, h, p))
    require(dy.dtype == x.dtype and s_in.dtype == torch.float32,
            f"{_KB}: dy must have x's dtype, s_in float32")
    tensors = dict(s_in=s_in, dy=dy)
    if dfinal is not None:
        check_shape(_KB, "dfinal", dfinal, (b, h, p, n))
        require(dfinal.dtype == torch.float32, f"{_KB}: dfinal must be float32")
        tensors["dfinal"] = dfinal
    check_tensors(_KB, x.device, ("dy",), **tensors)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, dB, dC = torch.empty_like(x), torch.empty_like(Bm), torch.empty_like(Cm)
    ddt, dA = torch.empty((b, l, h), **f32), torch.empty((h,), **f32)
    dinit = torch.empty((b, h, p, n), **f32) if with_dinit else None
    if b * h == 0:
        return dx.zero_(), ddt.zero_(), dA.zero_(), dB.zero_(), dC.zero_(), dinit
    hg = _head_group(h, g, nc, b, x.device)
    blocks = g * -(-(h // g) // hg)  # per chunk: each group's heads in blocks of hg
    ds_end = torch.empty((b, nc, h, p, n), **f32)
    dbp, dcp = (torch.empty((b, nc, blocks, q, n), **f32) for _ in range(2))
    dap = torch.empty((b, nc, h), **f32)
    err = _bwd_fn()(
        ptr(x), ptr(dt), ptr(A), ptr(Bm), ptr(Cm), ptr(dy), ptr(s_in),
        None if dfinal is None else ptr(dfinal),
        ptr(dx), ptr(ddt), ptr(dA), ptr(dB), ptr(dC), None if dinit is None else ptr(dinit),
        ptr(ds_end), ptr(dbp), ptr(dcp), ptr(dap),
        b, l, h, g, p, n, q, hg, DTYPE_CODE[x.dtype], _ROUTE_CODE[kernel], stream_ptr(x.device),
    )
    if err != 0:
        raise RuntimeError(f"{_KB}: kernel launch failed with cudaError {err}")
    ssd_bwd.launches += 1
    ssd_bwd.route_launches[kernel] += 1
    return dx, ddt, dA, dB, dC, dinit


def ssd_fwd(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, *,
    chunk: int = 128, init_state: Optional[torch.Tensor] = None, kernel: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(y, final_state, S_in (B, NC, H, P, N) f32): the forward `SSDScanFn`
    saves for its backward, the route's kernels writing the state at every
    chunk start on a CUDA tensor; on a CPU tensor the plain scan, and S_in
    None (the plain backward recomputes it)."""
    check_local(_K, x=x, dt=dt, A=A, Bm=Bm, Cm=Cm, init_state=init_state)
    _check_layout(_K, x, Bm, Cm)
    if op_stats.ACTIVE is not None:
        with op_stats.kernel(_K, lambda: work(*_work_args(x, Bm, chunk))):
            if x.is_meta:
                b, _, h, p = x.shape
                return (torch.empty_like(x),
                        x.new_empty((b, h, p, Bm.shape[-1]), dtype=torch.float32), None)
            return op_stats.dense(ssd_fwd(x, dt, A, Bm, Cm, chunk=chunk, init_state=init_state,
                                          kernel=kernel))
    if x.device.type == "cpu":
        y, fs = ssd_chunked(x, dt, A, Bm, Cm, min(chunk, x.shape[1]), init_state)
        return y, fs, None
    return _forward(x, dt, A, Bm, Cm, chunk, init_state, kernel, with_s_in=True)


class SSDScanFn(torch.autograd.Function):
    """`ssd` with its gradient: the forward kernels (writing S_in) and the
    backward kernels on CUDA tensors, `ssd_chunked` and `ssd_chunked_bwd` on
    CPU tensors. Gradients flow to x, dt, A, B, C and the initial state;
    the final state's gradient may be absent (None: zeros)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, init_state, chunk, kernel):
        ctx.set_materialize_grads(False)
        y, fs, s_in = ssd_fwd(x, dt, A, Bm, Cm, chunk=chunk, init_state=init_state, kernel=kernel)
        ctx.save_for_backward(x, dt, A, Bm, Cm, init_state, s_in)
        ctx.chunk = chunk
        return y, fs

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, Bm, Cm, init_state, s_in = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dx, ddt, dA, dB, dC, dinit = ssd_bwd(
            x, dt, A, Bm, Cm, s_in, dy, None if dfinal is None else dfinal.contiguous(),
            chunk=ctx.chunk, init_state=init_state, with_dinit=init_state is not None)
        return dx, ddt, dA, dB, dC, dinit, None, None


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def ssd(
    x: torch.Tensor,  # (B, L, H, P)
    dt: torch.Tensor,  # (B, L, H) f32, post-softplus
    A: torch.Tensor,  # (H,) f32, negative
    Bm: torch.Tensor,  # (B, L, G, N) with H % G == 0, or (B, L, N): one group
    Cm: torch.Tensor,  # as Bm
    *,
    chunk: int = 128,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N) f32; zeros if None
    kernel: Optional[str] = None,  # `TENSOR_CORE` or `SCALAR`; None: `route`'s choice
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, L, H, P) in x's dtype, final_state (B, H, P, N) f32);
    differentiable in x, dt, A, B, C and ``init_state`` (`SSDScanFn` on the
    card, autograd of the plain version on the CPU). ``kernel`` forces a
    route (to time one against the other); a route that cannot take the
    call raises."""
    check_local(_K, x=x, dt=dt, A=A, Bm=Bm, Cm=Cm, init_state=init_state)
    _check_layout(_K, x, Bm, Cm)
    if op_stats.ACTIVE is not None:
        if _needs_grad(x, dt, A, Bm, Cm, init_state):
            return SSDScanFn.apply(x, dt, A, Bm, Cm, init_state, chunk, kernel)
        with op_stats.kernel(_K, lambda: work(*_work_args(x, Bm, chunk))):
            if x.is_meta:
                b, _, h, p = x.shape
                return (torch.empty_like(x),
                        x.new_empty((b, h, p, Bm.shape[-1]), dtype=torch.float32))
            return op_stats.dense(ssd(x, dt, A, Bm, Cm, chunk=chunk, init_state=init_state,
                                      kernel=kernel))
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, Bm, Cm, min(chunk, x.shape[1]), init_state)
    if _needs_grad(x, dt, A, Bm, Cm, init_state):
        return SSDScanFn.apply(x, dt, A, Bm, Cm, init_state, chunk, kernel)
    y, final_state, _ = _forward(x, dt, A, Bm, Cm, chunk, init_state, kernel, with_s_in=False)
    return y, final_state


ssd.launches = 0  # calls that launched a kernel since the last reset
ssd.route_launches = {TENSOR_CORE: 0, SCALAR: 0}  # the same, by route
ssd_bwd.launches = 0  # backward calls (three kernels each) since the last reset
ssd_bwd.route_launches = {TENSOR_CORE: 0, SCALAR: 0}  # the same, by route
