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
    last = cums[:, :, -1]  # (b, nc, h)

    # ssd_state_pass
    w = dtc * torch.exp(last[:, :, None] - cums)
    xs = (xc * w[..., None]).to(bf16).to(f32)
    inc = torch.einsum("bcthp,bctn->bchpn", xs, Bc)
    s = init_state.to(f32) if init_state is not None else x.new_zeros((b, h, p, n), dtype=f32)
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = s * torch.exp(last[:, c])[..., None, None] + inc[:, c]
    s_in = torch.stack(s_in, dim=1).to(bf16).to(f32)  # (b, nc, h, p, n)

    # ssd_chunk_out
    g = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    ch = cums.permute(0, 1, 3, 2)  # (b, nc, h, q)
    decay = torch.exp(_segsum_from_cumsum(ch))  # 0 above the diagonal
    pm = (g[:, :, None] * decay * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]).to(bf16).to(f32)
    y = torch.einsum("bchij,bcjhp->bcihp", pm, xc)
    y = y + torch.exp(cums)[..., None] * torch.einsum("bcin,bchpn->bcihp", Cc, s_in)
    return y.reshape(b, nc * chunk, h, p)[:, :l].to(x.dtype), s
