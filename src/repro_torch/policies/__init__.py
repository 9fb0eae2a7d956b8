"""Scheduling-policy registry: protocols, factories, and the paper's
policies (plus baselines), registered by name exactly as in
``repro.policies``: prefill and decode for the server, router, deflection
and autoscaler for the session stack above it.

Importing this package registers every built-in policy. Public surface:

    PolicySpec           name + kwargs, the unit every factory consumes
    PrefillPolicy        protocol: select(queue, t_now, mu, budget)
    DecodePolicy         protocol: select(active, t_now) / observe(batch, t)
    RouterPolicy         protocol: select(replicas, request, prompt) -> idx
    DeflectionPolicy     protocol: decide(fleet, request, prompt) -> bool
    AutoscalerPolicy     protocol: decide(slo, n, n_min, n_max) -> target n
    register_prefill     class decorator, @register_prefill("my-policy")
    register_decode      class decorator (ctor takes the StepTimeLUT first)
    register_router      class decorator, @register_router("my-router")
    register_deflection  class decorator, @register_deflection("my-rule")
    register_autoscaler  class decorator, @register_autoscaler("my-scaler")
    make_prefill         spec|name -> PrefillPolicy
    make_decode          spec|name, lut -> DecodePolicy
    make_router          spec|name -> RouterPolicy
    make_deflection      spec|name -> DeflectionPolicy
    make_autoscaler      spec|name -> AutoscalerPolicy
    available_policies   {"prefill": ..., "decode": ..., "router": ...,
                          "deflection": ..., "autoscaler": ...}
"""
from repro_torch.policies.autoscale import (
    QueueThresholdAutoscaler,
    SLOAttainmentPIDAutoscaler,
    StaticAutoscaler,
)
from repro_torch.policies.decode import (
    ContinuousBatchingScheduler,
    SlackDecodeScheduler,
)
from repro_torch.policies.deflection import (
    NeverDeflect,
    PrefillPressureDeflect,
    ShortPromptDeflect,
    SlackAwareDeflect,
)
from repro_torch.policies.prefill import (
    EDFPrefillScheduler,
    FCFSPrefillScheduler,
    SJFPrefillScheduler,
    UrgencyPlusPrefillScheduler,
    UrgencyPrefillScheduler,
)
from repro_torch.policies.registry import (
    AutoscalerPolicy,
    DecodePolicy,
    DeflectionPolicy,
    Partition,
    PolicySpec,
    PrefillPolicy,
    RouterPolicy,
    Selection,
    available_autoscaler_policies,
    available_decode_policies,
    available_deflection_policies,
    available_policies,
    available_prefill_policies,
    available_router_policies,
    make_autoscaler,
    make_decode,
    make_deflection,
    make_prefill,
    make_router,
    register_autoscaler,
    register_decode,
    register_deflection,
    register_prefill,
    register_router,
)
from repro_torch.policies.router import (
    LeastQueuedRouter,
    PrefixAffinityRouter,
    RoundRobinRouter,
    SlackAwareRouter,
)

__all__ = [
    "ContinuousBatchingScheduler",
    "SlackDecodeScheduler",
    "EDFPrefillScheduler",
    "FCFSPrefillScheduler",
    "SJFPrefillScheduler",
    "UrgencyPlusPrefillScheduler",
    "UrgencyPrefillScheduler",
    "LeastQueuedRouter",
    "PrefixAffinityRouter",
    "RoundRobinRouter",
    "SlackAwareRouter",
    "NeverDeflect",
    "PrefillPressureDeflect",
    "ShortPromptDeflect",
    "SlackAwareDeflect",
    "QueueThresholdAutoscaler",
    "SLOAttainmentPIDAutoscaler",
    "StaticAutoscaler",
    "AutoscalerPolicy",
    "DecodePolicy",
    "DeflectionPolicy",
    "Partition",
    "PolicySpec",
    "PrefillPolicy",
    "RouterPolicy",
    "Selection",
    "available_autoscaler_policies",
    "available_decode_policies",
    "available_deflection_policies",
    "available_policies",
    "available_prefill_policies",
    "available_router_policies",
    "make_autoscaler",
    "make_decode",
    "make_deflection",
    "make_prefill",
    "make_router",
    "register_autoscaler",
    "register_decode",
    "register_deflection",
    "register_prefill",
    "register_router",
]
