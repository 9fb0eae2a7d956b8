"""Plain PyTorch reference of the served models, in float32 with TF32 off,
written from the published descriptions and independent of the program.

A decoder block as in Llama (which MiniCPM and Phi-3.5-MoE follow): RMSNorm
before attention and before the MLP, rotary embeddings on the queries and
keys, causal grouped-query attention (each layer at the window the
configuration's ``attention_windows`` gives it: a query at p sees the keys
k with p - w < k <= p; 0 or no key: the whole prefix), a residual around
each; the MLP a
SwiGLU, or (``num_experts`` > 0) a top-k mixture of SwiGLU experts routed by
a softmax over a linear router, the k gates renormalised to sum to one
(Mixtral's gating). Departures from the published models, which the
program shares and each configuration file lists under ``assumed``: the
norms scale by 1 + weight; MiniCPM's scale_emb, scale_depth and logit
scaling are left out; Phi-3.5-MoE's SparseMixer router is replaced by the
softmax top-k above; no expert drops a token.

Weights are read in the program's parameter layout (a tree of stacked
``(layers, ...)`` tensors, ``x @ w``) from tensors the benchmark made; each
layer is copied to float32 on its own, so the reference never holds more
than one layer in float32. ``quant="fp8"`` is the control: every matrix
product takes its inputs rounded to float8 e4m3 (weights per output
column, activations per row, each scaled to the format's largest value)
and computes in float32. ``quant="bf16"`` rounds them to bfloat16 instead,
the precision the configurations state: a witness of what rounding alone
does, not a check.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Sequence

import torch

_FP8_MAX = 448.0  # largest finite float8 e4m3fn


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded through float8 e4m3, scaled along ``dim``'s amax."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / _FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _bf16(t: torch.Tensor, dim: int) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


_ROUND = {None: None, "fp8": _fp8, "bf16": _bf16}


class _Mm:
    """x @ w in float32, or with both inputs rounded through ``quant``
    (float8 for the control, bfloat16 as a witness of the program's own
    precision) and accumulated in float32."""

    def __init__(self, quant: Optional[str]):
        if quant not in _ROUND:
            raise ValueError(f"unknown quant {quant!r}")
        self.round = _ROUND[quant]

    def w(self, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        return self.round(w, -2) if self.round else w

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.round:
            x = self.round(x, -1)
        return x @ w


@contextlib.contextmanager
def _no_tf32() -> Iterator[None]:
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + w.float())


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate the two halves of each head (x: (S, H, D))."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = pos.float()[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, block: int, window: int = 0) -> torch.Tensor:
    """Causal GQA attention of one sequence, in query blocks: q (S, Hq, D),
    k and v (S, Hkv, D); with ``window`` > 0 a query at p sees only the
    keys k > p - window."""
    s, hq, d = q.shape
    g = hq // k.shape[1]
    kk = k.repeat_interleave(g, dim=1).transpose(0, 1)  # (Hq, S, D)
    vv = v.repeat_interleave(g, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    kpos = torch.arange(s, device=q.device)
    for a in range(0, s, block):
        b = min(s, a + block)
        lo = max(0, a - window + 1) if window else 0  # the block's first visible key
        qb = q[a:b].transpose(0, 1)  # (Hq, n, D)
        sc = (qb @ kk[:, lo:b].transpose(1, 2)) / math.sqrt(d)  # (Hq, n, b - lo)
        qpos = torch.arange(a, b, device=q.device)[:, None]
        mask = kpos[None, lo:b] > qpos
        if window:
            mask |= kpos[None, lo:b] <= qpos - window
        sc = sc.masked_fill(mask[None], float("-inf"))
        out[a:b] = (torch.softmax(sc, dim=-1) @ vv[:, lo:b]).transpose(0, 1)
    return out


def _windows(m: Dict) -> List[int]:
    """Each layer's attention window from ``attention_windows`` (0 for
    every layer where the configuration states none)."""
    ws = m.get("attention_windows")
    if ws is None:
        return [0] * m["num_layers"]
    if len(ws) != m["num_layers"]:
        raise ValueError(f"attention_windows lists {len(ws)} layers, not {m['num_layers']}")
    return [int(w) for w in ws]


def _layer(lw: Dict, x: torch.Tensor, m: Dict, mm: _Mm, block: int,
           window: int = 0) -> torch.Tensor:
    s = x.shape[0]
    hq, hkv, hd, eps = m["num_heads"], m["num_kv_heads"], m["head_dim"], m["norm_eps"]
    pos = torch.arange(s, device=x.device)
    a = lw["attn"]
    h = _rms(x, lw["pre_attn_norm"], eps)
    q = _rope(mm(h, a["wq"]).view(s, hq, hd), pos, m["rope_theta"])
    k = _rope(mm(h, a["wk"]).view(s, hkv, hd), pos, m["rope_theta"])
    v = mm(h, a["wv"]).view(s, hkv, hd)
    x = x + mm(_attention(q, k, v, block, window).reshape(s, hq * hd), a["wo"])
    h = _rms(x, lw["pre_mlp_norm"], eps)
    if "moe" in lw:
        return x + _moe(lw["moe"], h, m, mm)
    p = lw["mlp"]
    return x + mm(torch.nn.functional.silu(mm(h, p["w_gate"])) * mm(h, p["w_up"]), p["w_down"])


def _moe(p: Dict, h: torch.Tensor, m: Dict, mm: _Mm) -> torch.Tensor:
    """Top-k mixture: each token's k best experts by the router's softmax,
    their gates renormalised, every routed token computed."""
    gates = torch.softmax(mm(h, p["router"]), dim=-1)
    topv, topi = torch.topk(gates, m["experts_per_token"], dim=-1)
    topv = topv / topv.sum(-1, keepdim=True)
    y = torch.zeros_like(h)
    for e in range(m["num_experts"]):
        rows, slot = (topi == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = h[rows]
        out = mm(torch.nn.functional.silu(mm(xe, p["w_gate"][e])) * mm(xe, p["w_up"][e]),
                 p["w_down"][e])
        y.index_add_(0, rows, out * topv[rows, slot][:, None])
    return y


def _layer_weights(layers: Dict, i: int, mm: _Mm) -> Dict:
    out = {}
    for k, v in layers.items():
        if isinstance(v, dict):
            out[k] = _layer_weights(v, i, mm)
        elif v.dim() >= 3:  # a stacked matrix (or stack of expert matrices)
            out[k] = mm.w(v[i])
        else:
            out[k] = v[i].float()
    return out


def logits_at(weights: Dict, m: Dict, seqs: Sequence[Sequence[int]],
              rows: Sequence[Sequence[int]], quant: Optional[str] = None,
              block: int = 512) -> List[torch.Tensor]:
    """For each token sequence ``seqs[j]``, the float32 logits (len(rows[j]),
    vocab) at its positions ``rows[j]``, from one causal forward pass over
    the whole sequence; layer by layer over all sequences."""
    dev = weights["embed"].device
    mm = _Mm(quant)
    windows = _windows(m)
    with torch.no_grad(), _no_tf32():
        xs = [weights["embed"][torch.tensor(list(s), device=dev)].float() for s in seqs]
        for i, window in enumerate(windows):
            lw = _layer_weights(weights["layers"], i, mm)
            xs = [_layer(lw, x, m, mm, block, window) for x in xs]
            del lw
        head = weights["embed"].T if m["tie_embeddings"] else weights["lm_head"]
        head = mm.w(head)
        out = []
        for x, r in zip(xs, rows, strict=True):
            h = _rms(x[torch.tensor(list(r), device=dev)], weights["final_norm"], m["norm_eps"])
            out.append(mm(h, head))
        return out
