"""The concrete checkers (one module per invariant; codes RPA001–RPA005)."""
from __future__ import annotations

from typing import Tuple

from repro_torch.analysis.checkers.asyncsafe import AsyncSafetyChecker
from repro_torch.analysis.checkers.clock import ClockHygieneChecker
from repro_torch.analysis.checkers.registry import RegistryCoverageChecker
from repro_torch.analysis.checkers.rng import RngDisciplineChecker
from repro_torch.analysis.checkers.schema import MetricsSchemaChecker

ALL_CHECKERS: Tuple[type, ...] = (
    ClockHygieneChecker,
    RngDisciplineChecker,
    AsyncSafetyChecker,
    RegistryCoverageChecker,
    MetricsSchemaChecker,
)

__all__ = [
    "ALL_CHECKERS",
    "AsyncSafetyChecker",
    "ClockHygieneChecker",
    "MetricsSchemaChecker",
    "RegistryCoverageChecker",
    "RngDisciplineChecker",
]
