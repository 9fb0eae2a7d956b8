"""Kairos core as the serving path and the simulator use it: request
model, finish-time predictor, the decode step-time LUT and the token
delivery pacer (host-side numpy, copied from the JAX package)."""
from repro_torch.core.lut import StepTimeLUT
from repro_torch.core.pacer import DeliveryPacer
from repro_torch.core.predictor import (
    PrefillThroughputEstimator,
    predict_all_finish_times,
    predict_finish_time_fcfs,
)
from repro_torch.core.request import Phase, Request, SLOSpec

__all__ = [
    "StepTimeLUT",
    "DeliveryPacer",
    "PrefillThroughputEstimator",
    "predict_all_finish_times",
    "predict_finish_time_fcfs",
    "Phase",
    "Request",
    "SLOSpec",
]
