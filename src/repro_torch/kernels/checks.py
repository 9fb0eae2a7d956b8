"""Argument checks shared by the kernel wrappers: a CUDA kernel takes raw
pointers, so everything it assumes is checked here before the launch."""
from __future__ import annotations

from typing import Sequence

import torch

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 80, 128, 256)  # of the attention kernels


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_tensors(kernel: str, device: torch.device, rows: Sequence[str],
                  **tensors: torch.Tensor) -> None:
    """Every tensor on ``device`` and contiguous; those named in ``rows``
    also 16-byte aligned (the kernels read their rows with 16-byte loads)."""
    for name, t in tensors.items():  # messages are formatted only on failure: this runs per launch
        if t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
        if name in rows and t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be 16-byte aligned")


def check_local(kernel: str, **tensors) -> None:
    """A kernel reads its operands through their pointers, which a DTensor's
    do not give (it holds one rank's shard): refuse one. A model on a mesh
    hands the wrappers each rank's local tensors (`repro_torch.dist.dtensor`
    lays them out for ``local_map``)."""
    for name, t in tensors.items():
        if type(t).__name__ == "DTensor":
            raise TypeError(f"{kernel}: {name} is a DTensor; a kernel takes local tensors "
                            "(send DTensor operands through local_map)")


def check_shape(kernel: str, name: str, t: torch.Tensor, shape: Sequence[int]) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def ptr(t: torch.Tensor) -> int:
    """The address of ``t``'s data: every entry point declares its pointer
    arguments ``c_void_p`` (argtypes), so ctypes passes it at full width."""
    return t.data_ptr()


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_no_grad(kernel: str, why: str, **tensors) -> None:
    """A kernel writes into a fresh tensor that autograd cannot see through:
    refuse, under grad mode, any input that requires grad, so a gradient is
    never dropped silently. A call through the kernel's
    `torch.autograd.Function` passes (its forward runs with grad mode off);
    ``why`` says what carries the gradient instead, or why none does."""
    if torch.is_grad_enabled():
        for name, t in tensors.items():
            if t is not None and t.requires_grad:
                raise RuntimeError(f"{kernel}: {name} requires grad, but the kernel carries no "
                                   f"gradient ({why}); call it under torch.no_grad()")
