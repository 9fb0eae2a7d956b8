"""Plain PyTorch version of the SSD scan kernel: the Mamba2 chunked scan of
``repro.models.ssm.ssd_chunked`` (the oracle of the TPU kernel's tests)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., T). Returns (..., T, T) with [i,j] = sum_{k=j+1..i} x_k for
    j<=i, -inf above the diagonal."""
    return _segsum_from_cumsum(torch.cumsum(x, dim=-1))


def _segsum_from_cumsum(cs: torch.Tensor) -> torch.Tensor:
    """cs: (..., T) an inclusive cumsum. Returns (..., T, T) with [i, j] =
    cs_i - cs_j for j <= i and -inf above the diagonal."""
    t = cs.shape[-1]
    ii = torch.arange(t, device=cs.device)
    tril = ii[:, None] >= ii[None, :]
    return (cs[..., :, None] - cs[..., None, :]).masked_fill(~tril, float("-inf"))


def ssd_chunked(
    x: torch.Tensor,  # (B, L, H, P)
    dt: torch.Tensor,  # (B, L, H), already softplus'd, zero on padded slots
    A: torch.Tensor,  # (H,) negative
    B: torch.Tensor,  # (B, L, G, N)
    C: torch.Tensor,  # (B, L, G, N)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,L,H,P) in x's dtype, final_state (B,H,P,N) f32)."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nc = -(-l // chunk)
    pad = nc * chunk - l
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))

    f32 = torch.float32
    rep = h // g
    xc = x.reshape(b, nc, chunk, h, p).to(f32)
    dtc = dt.reshape(b, nc, chunk, h).to(f32)
    Bh = B.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3).to(f32)
    Ch = C.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3).to(f32)

    dA = dtc * A.to(f32)  # (b, nc, cs, h)
    dA_cs = torch.cumsum(dA, dim=2)
    xdt = xc * dtc[..., None]

    # 1. intra-chunk (quadratic within chunk)
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))  # (b, nc, h, cs, cs)
    scores = torch.einsum("bcshn,bcthn->bchst", Ch, Bh)
    y_diag = torch.einsum("bchst,bcthp->bcshp", scores * L, xdt)

    # 2. per-chunk input states
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)  # (b, nc, cs, h)
    states = torch.einsum("bcthn,bcth,bcthp->bchpn", Bh, decay_states, xdt)

    # 3. inter-chunk recurrence
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])  # (b, nc, h)
    s = init_state.to(f32) if init_state is not None else x.new_zeros((b, h, p, n), dtype=f32)
    s_in = []
    for c in range(nc):
        s_in.append(s)  # state at chunk start
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    s_in = torch.stack(s_in, dim=1)  # (b, nc, h, p, n)

    # 4. state -> output within chunk
    y_off = torch.einsum("bcshn,bchpn,bcsh->bcshp", Ch, s_in, torch.exp(dA_cs))

    y = (y_diag + y_off).reshape(b, nc * chunk, h, p)[:, :l]
    return y.to(x.dtype), s


def ssd_tensor_core_emulation(
    x: torch.Tensor,  # (B, L, H, P)
    dt: torch.Tensor,  # (B, L, H) f32
    A: torch.Tensor,  # (H,) f32
    B: torch.Tensor,  # (B, L, N), ngroups = 1
    C: torch.Tensor,  # (B, L, N)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tensor-core route of the kernel (``ssd_state_pass`` then
    ``ssd_chunk_out``) written out in f32 with its rounding points: x, B
    and C as given (bf16 on that route), the scaled x of the state
    increment x dt exp(cums_last - cums) rounded to bf16, the carried state
    never rounded, the state at each chunk start (``S_in``) rounded to bf16
    as the operand of C S_in^T, and the decayed scores
    P = (C B^T) exp(cums_i - cums_j) dt_j rounded to bf16 before P x.
    Returns (y in x's dtype, final_state f32), as `ssd_chunked`."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    nc = -(-l // chunk)
    pad = nc * chunk - l
    f32, bf16 = torch.float32, torch.bfloat16
    xc = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(b, nc, chunk, h, p)
    dtc = F.pad(dt.float(), (0, 0, 0, pad)).reshape(b, nc, chunk, h)
    Bc = F.pad(B.float(), (0, 0, 0, pad)).reshape(b, nc, chunk, n)
    Cc = F.pad(C.float(), (0, 0, 0, pad)).reshape(b, nc, chunk, n)
    cums = torch.cumsum(dtc * A.float(), dim=2)  # (b, nc, q, h); pad rows keep the last

    s_in, s = _chunk_states(xc, dtc, Bc, cums, init_state, tensor_core=True)  # ssd_state_pass
    s_in = s_in.to(bf16).to(f32)

    # ssd_chunk_out
    g = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    ch = cums.permute(0, 1, 3, 2)  # (b, nc, h, q)
    decay = torch.exp(_segsum_from_cumsum(ch))  # 0 above the diagonal
    pm = (g[:, :, None] * decay * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]).to(bf16).to(f32)
    y = torch.einsum("bchij,bcjhp->bcihp", pm, xc)
    y = y + torch.exp(cums)[..., None] * torch.einsum("bcin,bchpn->bcihp", Cc, s_in)
    return y.reshape(b, nc * chunk, h, p)[:, :l].to(x.dtype), s


def _chunk_states(xc, dtc, Bc, cums, init_state, tensor_core=False):
    """(the state at every chunk start (b, nc, h, p, n), the final state),
    f32, by the forward's recurrence from chunked f32 x (b, nc, q, h, p), dt
    (b, nc, q, h), B (b, nc, q, n) and the in-chunk cumsum of dt A. With
    ``tensor_core``, ``ssd_state_pass`` written out: the scaled x of the
    state increment, x dt exp(cums_last - cums), rounded to bf16 (the
    carried state never is)."""
    b, nc, _, h, p = xc.shape
    n = Bc.shape[-1]
    f32 = torch.float32
    last = cums[:, :, -1]  # (b, nc, h)
    xs = xc * (dtc * torch.exp(last[:, :, None] - cums))[..., None]
    if tensor_core:
        xs = xs.to(torch.bfloat16).to(f32)
    inc = torch.einsum("bcthp,bctn->bchpn", xs, Bc)
    s = init_state.to(f32) if init_state is not None else xc.new_zeros((b, h, p, n), dtype=f32)
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = s * torch.exp(last[:, c])[..., None, None] + inc[:, c]
    return torch.stack(s_in, dim=1), s


def ssd_tensor_core_states(
    x: torch.Tensor,  # (B, L, H, P)
    dt: torch.Tensor,  # (B, L, H) f32
    A: torch.Tensor,  # (H,) f32
    B: torch.Tensor,  # (B, L, N), ngroups = 1
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N) f32
) -> torch.Tensor:
    """S_in (B, NC, H, P, N) f32 as the forward's tensor-core route writes it
    for the backward: the state at every chunk start, built from the bf16
    rounded state increments (`ssd_tensor_core_emulation`). With it,
    `ssd_chunked_bwd` on bf16 inputs is what the bf16 backward computes on
    the card after that route: the backward kernels widen bf16 to f32 and
    round only dx, dB and dC, as `ssd_chunked_bwd` casts them."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    nc = -(-l // chunk)
    pad = nc * chunk - l
    xc = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(b, nc, chunk, h, p)
    dtc = F.pad(dt.float(), (0, 0, 0, pad)).reshape(b, nc, chunk, h)
    Bc = F.pad(B.float(), (0, 0, 0, pad)).reshape(b, nc, chunk, n)
    cums = torch.cumsum(dtc * A.float(), dim=2)
    return _chunk_states(xc, dtc, Bc, cums, init_state, tensor_core=True)[0]


def _reverse_cumsum(t: torch.Tensor, dim: int) -> torch.Tensor:
    """[..., k, ...] = sum over i >= k along ``dim``."""
    return torch.flip(torch.cumsum(torch.flip(t, (dim,)), dim=dim), (dim,))


def ssd_chunked_bwd(
    x: torch.Tensor,  # (B, L, H, P)
    dt: torch.Tensor,  # (B, L, H) f32
    A: torch.Tensor,  # (H,) f32
    B: torch.Tensor,  # (B, L, N), ngroups = 1
    C: torch.Tensor,  # (B, L, N)
    chunk: int,
    init_state: Optional[torch.Tensor],  # (B, H, P, N) f32 or None (zeros)
    s_in: Optional[torch.Tensor],  # (B, NC, H, P, N) f32, the state at every chunk start
    dy: torch.Tensor,  # (B, L, H, P)
    dfinal: Optional[torch.Tensor],  # (B, H, P, N) f32, or None (the final state unused)
) -> Tuple[torch.Tensor, ...]:
    """The gradient of `ssd_chunked` (ngroups = 1) written out in plain
    tensor ops, without autograd: (dx, ddt, dA, dB, dC, dinit), given the
    cotangents ``dy`` of y and ``dfinal`` of the final state. ``s_in`` is
    what the forward saved; None recomputes it. dx, dB and dC come in their
    inputs' dtypes, ddt, dA and dinit (the gradient of ``init_state``, or of
    a zero initial state) in f32. The oracle of the backward kernels
    (``csrc/ssd_scan_bwd.cu``) and the CPU path of ``ops.SSDScanFn``.

    Per (b, h) and chunk, rows i, j, with a = dt A, cums its inclusive cumsum
    in the chunk, last its last row, G = C B^T, E_ij = exp(cums_i - cums_j)
    for j <= i (else 0), M = G E, S the state at the chunk's start and dS
    the gradient of the state at its end:
      dS_start = exp(cums_last) dS + sum_i exp(cums_i) dy_i C_i^T
      dx_j = dt_j (sum_i M_ij dy_i + exp(cums_last - cums_j) dS B_j)
      dC_i = sum_j dG_ij B_j + exp(cums_i) S^T dy_i,
      dB_j = sum_i dG_ij C_i + exp(cums_last - cums_j) dt_j dS^T x_j,
        dG_ij = (dy_i . x_j) dt_j E_ij, both summed over the heads
      ddt_j = sum_i M_ij (dy_i . x_j) + exp(cums_last - cums_j) u_j + A da_j,
        u_j = x_j^T dS B_j,
    with da the reverse cumsum in the chunk of
      dcums_i = sum_j R_ij - sum_k R_ki + exp(cums_i) dy_i . (S C_i)
                - exp(cums_last - cums_i) dt_i u_i,  R_ij = M_ij dt_j (dy_i . x_j),
    plus exp(cums_last) <dS, S> + sum_j exp(cums_last - cums_j) dt_j u_j on
    the last row, and dA = sum dt da. E is a select over j <= i, never a
    product with a mask and never exp(cums_i) exp(-cums_j): both overflow.
    Padded rows of a ragged last chunk (dt = 0 there) get no gradient."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    nc = -(-l // chunk)
    pad = nc * chunk - l
    f32 = torch.float32
    xc = F.pad(x.to(f32), (0, 0, 0, 0, 0, pad)).reshape(b, nc, chunk, h, p)
    dyc = F.pad(dy.to(f32), (0, 0, 0, 0, 0, pad)).reshape(b, nc, chunk, h, p)
    dtc = F.pad(dt.to(f32), (0, 0, 0, pad)).reshape(b, nc, chunk, h)
    Bc = F.pad(B.to(f32), (0, 0, 0, pad)).reshape(b, nc, chunk, n)
    Cc = F.pad(C.to(f32), (0, 0, 0, pad)).reshape(b, nc, chunk, n)
    A = A.to(f32)
    cums = torch.cumsum(dtc * A, dim=2)  # (b, nc, q, h); pad rows keep the last
    last = cums[:, :, -1]  # (b, nc, h)
    if s_in is None:
        s_in = _chunk_states(xc, dtc, Bc, cums, init_state)[0]
    s_in = s_in.to(f32)
    ei = torch.exp(cums)  # exp(cums_i)
    eo = torch.exp(last[:, :, None] - cums)  # exp(cums_last - cums_j)

    # the state's gradient, last chunk first: dS at every chunk's end
    inc = torch.einsum("bcih,bcihp,bcin->bchpn", ei, dyc, Cc)
    ds = dfinal.to(f32) if dfinal is not None else x.new_zeros((b, h, p, n), dtype=f32)
    ds_end = [None] * nc
    for c in reversed(range(nc)):
        ds_end[c] = ds
        ds = torch.exp(last[:, c])[..., None, None] * ds + inc[:, c]
    dinit = ds
    ds_end = torch.stack(ds_end, dim=1)  # (b, nc, h, p, n)

    e = torch.exp(_segsum_from_cumsum(cums.permute(0, 1, 3, 2)))  # (b, nc, h, q, q), 0 above
    dtj = dtc.permute(0, 1, 3, 2)[..., None, :]  # dt_j on the columns
    g = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    dyx = torch.einsum("bcihp,bcjhp->bchij", dyc, xc)
    m = g[:, :, None] * e
    dg = dyx * e * dtj
    k = m * dyx
    r = k * dtj

    v = torch.einsum("bchpn,bcjn->bcjhp", ds_end, Bc)  # dS B_j
    w = torch.einsum("bchpn,bcihp->bcihn", s_in, dyc)  # S^T dy_i
    z = torch.einsum("bchpn,bcjhp->bcjhn", ds_end, xc)  # dS^T x_j
    u = (xc * v).sum(-1)  # (b, nc, q, h)
    qv = (Cc[:, :, :, None, :] * w).sum(-1)  # C_i . S^T dy_i

    dx = dtc[..., None] * (torch.einsum("bchij,bcihp->bcjhp", m, dyc) + eo[..., None] * v)
    dC = torch.einsum("bchij,bcjn->bcin", dg, Bc) + torch.einsum("bcih,bcihn->bcin", ei, w)
    dB = torch.einsum("bchij,bcin->bcjn", dg, Cc) + torch.einsum("bcjh,bcjhn->bcjn", eo * dtc, z)
    ddt = k.sum(-2).permute(0, 1, 3, 2) + eo * u
    dcums = (r.sum(-1) - r.sum(-2)).permute(0, 1, 3, 2) + ei * qv - eo * dtc * u
    # the last (padded) row: its reverse cumsum reaches every valid row of the chunk
    dcums[:, :, -1] += (torch.exp(last) * (ds_end * s_in).sum((-2, -1))
                        + (eo * dtc * u).sum(2))
    da = _reverse_cumsum(dcums, 2)
    ddt = ddt + A * da
    dA = (dtc * da).sum((0, 1, 2))

    def rows(t):
        return t.reshape(b, nc * chunk, *t.shape[3:])[:, :l]

    return (rows(dx).to(x.dtype), rows(ddt), dA, rows(dB).to(B.dtype), rows(dC).to(C.dtype),
            dinit)
