"""Random weights from the run's seed, made on the device in the port's
parameter layout and in the dtype they are served in.

The leaves' shapes and dtypes come from ``Model.param_struct()`` (meta
tensors). Each dtype's leaves are views into one flat buffer, filled by a
few large normal draws from a ``torch.Generator`` on the device, then
scaled per leaf: matrices by 1/sqrt(fan-in) (fan-in = the second-to-last
axis), the embedding by 0.02, norm weights set to zero (the port's norms
scale by 1 + weight). The same tensors go to the program and to the
reference.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

_CHUNK = 1 << 28  # elements per draw


def _leaves(tree: Dict, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _leaves(v, f"{prefix}{k}/")
        else:
            out.append((prefix + k, v))
    return out


def _set(tree: Dict, path: str, value: torch.Tensor) -> None:
    *head, last = path.split("/")
    for k in head:
        tree = tree[k]
    tree[last] = value


def _scale(path: str, shape) -> float:
    name = path.rsplit("/", 1)[-1]
    if "norm" in name:
        return 0.0
    if name == "embed":
        return 0.02
    return 1.0 / math.sqrt(shape[-2])


def make_weights(struct: Dict, seed: int, device: torch.device) -> Dict:
    """A parameter tree shaped as ``struct`` (meta tensors), drawn from
    ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    leaves = _leaves(struct)
    out: Dict = {}
    _copy_dicts(struct, out)
    for dtype in sorted({t.dtype for _, t in leaves}, key=str):
        mine = [(p, t) for p, t in leaves if t.dtype == dtype]
        total = sum(t.numel() for _, t in mine)
        buf = torch.empty(total, dtype=dtype, device=device)
        for off in range(0, total, _CHUNK):
            buf[off:off + _CHUNK].normal_(generator=gen)
        off = 0
        for path, meta in mine:
            view = buf[off:off + meta.numel()].view(meta.shape)
            off += meta.numel()
            s = _scale(path, meta.shape)
            if s == 0.0:
                view.zero_()
            else:
                view.mul_(s)
            _set(out, path, view)
    return out


def _copy_dicts(src: Dict, dst: Dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            dst[k] = {}
            _copy_dicts(v, dst[k])
