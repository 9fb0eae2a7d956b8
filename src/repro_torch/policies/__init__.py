"""Scheduling policies of the serving path: the prefill side (Kairos
urgency and its baselines) and the decode side (Kairos slack and continuous
batching), registered by name exactly as in ``repro.policies``.

Importing this package registers every built-in prefill and decode policy.
The router, deflection and autoscaler sides are not ported yet.
"""
from repro_torch.policies.decode import (
    ContinuousBatchingScheduler,
    SlackDecodeScheduler,
)
from repro_torch.policies.prefill import (
    EDFPrefillScheduler,
    FCFSPrefillScheduler,
    SJFPrefillScheduler,
    UrgencyPlusPrefillScheduler,
    UrgencyPrefillScheduler,
)
from repro_torch.policies.registry import (
    DecodePolicy,
    Partition,
    PolicySpec,
    PrefillPolicy,
    Selection,
    available_decode_policies,
    available_policies,
    available_prefill_policies,
    make_decode,
    make_prefill,
    register_decode,
    register_prefill,
)

__all__ = [
    "ContinuousBatchingScheduler",
    "SlackDecodeScheduler",
    "EDFPrefillScheduler",
    "FCFSPrefillScheduler",
    "SJFPrefillScheduler",
    "UrgencyPlusPrefillScheduler",
    "UrgencyPrefillScheduler",
    "DecodePolicy",
    "Partition",
    "PolicySpec",
    "PrefillPolicy",
    "Selection",
    "available_decode_policies",
    "available_policies",
    "available_prefill_policies",
    "make_decode",
    "make_prefill",
    "register_decode",
    "register_prefill",
]
