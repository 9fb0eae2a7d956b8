"""Kairos core as the serving path uses it: request model, finish-time
predictor and the decode step-time LUT (host-side numpy, copied from the
JAX package)."""
from repro_torch.core.lut import StepTimeLUT
from repro_torch.core.predictor import (
    PrefillThroughputEstimator,
    predict_all_finish_times,
    predict_finish_time_fcfs,
)
from repro_torch.core.request import Phase, Request, SLOSpec

__all__ = [
    "StepTimeLUT",
    "PrefillThroughputEstimator",
    "predict_all_finish_times",
    "predict_finish_time_fcfs",
    "Phase",
    "Request",
    "SLOSpec",
]
