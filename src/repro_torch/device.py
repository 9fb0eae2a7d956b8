"""Device resolution shared by the port's entry points."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a `torch.device`; raises when it names CUDA and no card
    is present, so an entry point never carries on silently on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device '{dev}' requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain path on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device '{dev}': use 'cuda' or 'cpu'")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work, so a host clock read after it
    measures the work and not its launch. A no-op on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
