"""Argument checks shared by the kernel wrappers: a CUDA kernel takes raw
pointers, so everything it assumes is checked here before the launch."""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 80, 128)  # of the attention kernels


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_tensors(kernel: str, device: torch.device, rows: Sequence[str],
                  **tensors: torch.Tensor) -> None:
    """Every tensor on ``device`` and contiguous; those named in ``rows``
    also 16-byte aligned (the kernels read their rows with 16-byte loads)."""
    for name, t in tensors.items():
        require(t.device == device, f"{kernel}: {name} is on {t.device}, expected {device}")
        require(t.is_contiguous(), f"{kernel}: {name} must be contiguous")
        if name in rows:
            require(t.data_ptr() % 16 == 0, f"{kernel}: {name} must be 16-byte aligned")


def check_shape(kernel: str, name: str, t: torch.Tensor, shape: Sequence[int]) -> None:
    require(tuple(t.shape) == tuple(shape), f"{kernel}: {name} has shape {tuple(t.shape)}, "
            f"expected {tuple(shape)}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
