"""Config registry: ``get_config(name)`` / ``list_configs()``.

A copy of the JAX package's registry: the port keeps its own configs so it
imports nothing of ``repro``.
"""
from __future__ import annotations

from repro_torch.configs.archs import ALL_ARCHS, ASSIGNED
from repro_torch.configs.base import ModelConfig, reduced_config
from repro_torch.configs.shapes import (
    ALL_SHAPES,
    ShapeSpec,
    input_specs,
    shape_applicable,
)


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return reduced_config(get_config(name[: -len("-smoke")]))
    try:
        return ALL_ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ALL_ARCHS)}") from None


def list_configs():
    return sorted(ALL_ARCHS)


__all__ = [
    "ModelConfig",
    "ShapeSpec",
    "ALL_ARCHS",
    "ALL_SHAPES",
    "ASSIGNED",
    "get_config",
    "list_configs",
    "reduced_config",
    "input_specs",
    "shape_applicable",
]
