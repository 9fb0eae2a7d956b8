"""Mesh construction on ``torch.distributed`` (port of ``repro.launch.mesh``).

Importing this module starts no process group; meshes are built by
functions only, each over the process group already started in this
process (one per process). Single pod: 16x16 = 256 ranks ('data' x
'model'); multi-pod: 2 x 16 x 16 = 512 ranks ('pod' x 'data' x 'model').

- On the card: start a NCCL group (``torch.distributed.init_process_group(
  "nccl", init_method="tcp://localhost:<port>", world_size=n, rank=r)``)
  and call ``make_mesh(shape, axes)``; a mesh on ``"cuda"`` raises when no
  card is present, as `device.resolve_device` does.
- For a dry-run: ``init_fake_world(n)`` starts PyTorch's fake process group
  of n ranks in this one process (this process is rank 0; collectives are
  accepted and move nothing), and the meshes are built with device type
  ``"cpu"`` while their tensors live on ``meta``: nothing is allocated.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.device import resolve_device


def init_fake_world(n: int = 512) -> None:
    """Start the fake process group of ``n`` ranks for a dry-run (the
    counterpart of the reference's ``ensure_host_platform_devices``): a
    production mesh's placements, sharding propagation and collectives on
    one host. Refuses a second group in one process."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == n:
            return
        raise RuntimeError("a process group is already started in this process: "
                           f"{dist.get_backend()} of {dist.get_world_size()} ranks")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _device_type(device: str) -> str:
    dev = torch.device(device)
    if dev.type == "meta":
        return "cpu"  # a dry-run's tensors live on meta, its mesh on the host
    return resolve_device(dev).type


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the started group
    (its world size must be the product of ``shape``)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_device_type(device), tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(device: str = "cpu"):
    """Every rank of the started group, one axis each of data/model (the
    CPU tests' gloo ranks)."""
    import torch.distributed as dist

    return make_mesh((dist.get_world_size(), 1), ("data", "model"), device)
