"""Mamba2 (SSD, state-space duality) block in PyTorch (port of
``repro.models.ssm``).

The chunked SSD scan of prefill and training goes through the `ssd`
wrapper: the hand-written kernel on the card (under grad with its backward
kernels, ``SSDScanFn``), its plain version (``ssd_chunked``) on the CPU.
The reference's ``ssm_forward`` calls ``ssd_chunked`` and never its TPU
kernel; the port calls the kernel, held to the same function. Decode is
the O(1)-per-token recurrence, in plain PyTorch.

Two departures from the reference, both recorded in ROADMAP §C:
- C2: a right-padded prefill keeps the conv window of the W-1 rows that end
  at ``valid_len`` (the reference keeps the last W-1 rows of the padded
  input, ``ssm.py:174``, so a decode after it reads padding tokens).
- C3: the conv cache leaf has the model's dtype (the reference's spec says
  bfloat16, ``ssm.py:241``, while its decode carries the model's dtype; the
  port writes caches in place, so a bf16 leaf would round an f32 window on
  every step).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan.ops import ssd
from repro_torch.models.layers import dense_init, gated_rms_norm


def conv_channels(cfg: ModelConfig) -> int:
    return cfg.ssm_d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state_dim


def init_ssm_params(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
                    device: torch.device) -> Dict:
    """One layer's weights with the reference's distributions, drawn from
    ``gen``."""
    d, di, h = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_num_heads
    g, n, w = cfg.ssm_ngroups, cfg.ssm_state_dim, cfg.ssm_conv_width
    cch = conv_channels(cfg)
    f32 = torch.float32
    # dt bias: inverse-softplus of dt ~ exp(U[log 1e-3, log 1e-1])
    u = torch.rand((h,), generator=gen, dtype=f32, device=device)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    conv_w = torch.randn((w, cch), generator=gen, dtype=f32, device=device) / math.sqrt(w)
    a = torch.rand((h,), generator=gen, dtype=f32, device=device) * 15.0 + 1.0  # U[1, 16]
    return dict(
        in_proj=dense_init(gen, (d, 2 * di + 2 * g * n + h), dtype, device),
        conv_w=conv_w.to(dtype),
        conv_b=torch.zeros((cch,), dtype=dtype, device=device),
        A_log=torch.log(a),
        D=torch.ones((h,), dtype=f32, device=device),
        dt_bias=dt_bias,
        norm=torch.zeros((di,), dtype=dtype, device=device),
        out_proj=dense_init(gen, (di, d), dtype, device),
    )


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, L, C); w: (W, C); b: (C,)."""
    width, length = w.shape[0], x.shape[1]
    xt = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):  # W is tiny (4): unrolled adds, as the reference
        out = out + xt[:, i : i + length].float() * w[i].float()
    return F.silu(out + b.float()).to(x.dtype)


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    di = cfg.ssm_d_inner
    gn = cfg.ssm_ngroups * cfg.ssm_state_dim
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di : di + di + 2 * gn]
    dt_raw = zxbcdt[..., di + di + 2 * gn :]
    return z, xbc, dt_raw


def ssm_forward(
    params: Dict,
    x_in: torch.Tensor,  # (B, L, D)
    cfg: ModelConfig,
    valid_len: Optional[torch.Tensor] = None,  # (B,): dt is masked past it
    init_cache: Optional[Dict] = None,  # conv (B, W-1, Cch), state (B, H, P, N)
) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence / chunked-prefill SSD pass. Returns (y (B,L,D), cache):
    the cache's conv window is the W-1 rows that end at ``valid_len`` (C2)."""
    b, l, _ = x_in.shape
    h, p, di = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_d_inner
    g, n, width = cfg.ssm_ngroups, cfg.ssm_state_dim, cfg.ssm_conv_width
    dev = x_in.device

    z, xbc, dt_raw = _split_proj(x_in @ params["in_proj"], cfg)

    head = (init_cache["conv"].to(xbc.dtype) if init_cache is not None
            else xbc.new_zeros((b, width - 1, xbc.shape[-1])))
    # row r of xbc is row r + W-1 of ext; without a cache the zeros ahead of
    # it are the causal padding of the reference's conv over xbc alone
    ext = torch.cat([head, xbc], dim=1)
    conv_out = causal_conv(ext, params["conv_w"], params["conv_b"])[:, width - 1 :]
    if valid_len is None:
        valid_len = torch.full((b,), l, dtype=torch.int32, device=dev)
    valid_len = valid_len.to(device=dev, dtype=torch.long)
    rows = valid_len[:, None] + torch.arange(width - 1, device=dev)[None, :]  # (B, W-1)
    new_conv = torch.gather(ext, 1, rows[:, :, None].expand(-1, -1, ext.shape[-1]))

    xs = conv_out[..., :di].reshape(b, l, h, p)
    bmat = conv_out[..., di : di + g * n]
    cmat = conv_out[..., di + g * n :]

    dt = F.softplus(dt_raw.float() + params["dt_bias"])  # (B, L, H)
    pos = torch.arange(l, device=dev)[None, :, None]
    dt = torch.where(pos < valid_len[:, None, None], dt, 0.0)
    A = -torch.exp(params["A_log"])

    init_state = init_cache["state"].float().contiguous() if init_cache is not None else None
    y, final_state = ssd(xs.contiguous(), dt.contiguous(), A.contiguous(),
                         bmat.contiguous(), cmat.contiguous(),
                         chunk=cfg.ssm_chunk, init_state=init_state)
    y = y + params["D"].float()[None, None, :, None] * xs.float()
    y = y.reshape(b, l, di).to(x_in.dtype)
    y = gated_rms_norm(y, z, params["norm"], cfg.norm_eps)
    return y @ params["out_proj"], dict(conv=new_conv.to(x_in.dtype), state=final_state)


def ssm_decode_step(
    params: Dict,
    x_in: torch.Tensor,  # (B, 1, D)
    cfg: ModelConfig,
    cache: Dict,  # conv (B, W-1, Cch), state (B, H, P, N)
) -> Tuple[torch.Tensor, Dict]:
    """One token through the recurrence. Returns (y (B,1,D), new cache)."""
    b = x_in.shape[0]
    h, p = cfg.ssm_num_heads, cfg.ssm_head_dim
    g, n, di = cfg.ssm_ngroups, cfg.ssm_state_dim, cfg.ssm_d_inner
    f32 = torch.float32

    z, xbc, dt_raw = _split_proj((x_in @ params["in_proj"])[:, 0], cfg)

    window = torch.cat([cache["conv"].to(xbc.dtype), xbc[:, None, :]], dim=1)  # (B, W, C)
    conv_out = torch.einsum("bwc,wc->bc", window.float(), params["conv_w"].float())
    conv_out = F.silu(conv_out + params["conv_b"].float()).to(x_in.dtype)
    new_conv = window[:, 1:, :]

    xs = conv_out[..., :di].reshape(b, h, p)
    rep = h // g
    bh = conv_out[..., di : di + g * n].reshape(b, g, n).repeat_interleave(rep, dim=1)
    ch = conv_out[..., di + g * n :].reshape(b, g, n).repeat_interleave(rep, dim=1)

    dt = F.softplus(dt_raw.float() + params["dt_bias"])  # (B, H)
    dA = torch.exp(dt * -torch.exp(params["A_log"]))

    inc = torch.einsum("bhp,bhn->bhpn", xs.float() * dt[..., None], bh.float())
    state = cache["state"].to(f32) * dA[..., None, None] + inc
    y = torch.einsum("bhn,bhpn->bhp", ch.float(), state)
    y = y + params["D"][None, :, None] * xs.float()
    y = gated_rms_norm(y.reshape(b, di).to(x_in.dtype), z, params["norm"], cfg.norm_eps)
    return (y @ params["out_proj"])[:, None, :], dict(conv=new_conv.to(x_in.dtype), state=state)


def ssm_cache_shape(cfg: ModelConfig, batch: int) -> Dict:
    """{leaf: (shape, dtype-name)} of one layer's recurrent cache; the conv
    leaf has the model's dtype (C3)."""
    return dict(
        conv=((batch, cfg.ssm_conv_width - 1, conv_channels(cfg)), cfg.dtype),
        state=((batch, cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state_dim), "float32"),
    )
