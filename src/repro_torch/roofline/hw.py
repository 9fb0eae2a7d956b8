"""Target hardware constants for the roofline: one NVIDIA H100 SXM5 80 GB,
the card ``chip_smoke.py`` runs on ("NVIDIA H100 80GB HBM3", 700 W).

Source: NVIDIA H100 Tensor Core GPU data sheet,
https://www.nvidia.com/en-us/data-center/h100/ (SXM column; dense rates,
without sparsity, at the full 700 W power limit: a card set below it runs
slower under load).
"""
from __future__ import annotations

from dataclasses import dataclass

SOURCE = "NVIDIA H100 Tensor Core GPU data sheet, https://www.nvidia.com/en-us/data-center/h100/"


@dataclass(frozen=True)
class ChipSpec:
    """The reference's fields (``ici_*`` name the chip-to-chip links, on a
    GPU NVLink) plus ``peak_flops_f32``, which the port's f32 bounds use."""

    name: str
    peak_flops_bf16: float  # dense FLOP/s per chip
    hbm_bw: float  # bytes/sec per chip
    hbm_bytes: float  # capacity per chip
    ici_link_bw: float  # bytes/sec per link
    ici_links: int  # links per chip
    dcn_bw: float  # bytes/sec per chip across hosts
    peak_flops_f32: float  # FLOP/s per chip outside the tensor cores


H100 = ChipSpec(
    name="nvidia-h100-sxm5-80gb",
    peak_flops_bf16=989e12,
    hbm_bw=3.35e12,  # HBM3
    hbm_bytes=80e9,
    # NVLink 4: 18 links, 900 GB/s in all; a link's 50 GB/s counts both
    # directions (25 GB/s each way)
    ici_link_bw=50e9,
    ici_links=18,
    # the system's figure, not the card's: a DGX H100 gives each GPU one
    # ConnectX-7 port of 400 Gb/s to the other hosts
    dcn_bw=400e9 / 8,
    peak_flops_f32=67e12,
)
