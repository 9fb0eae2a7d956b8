"""Distribution layer of the port: sharding plans, activation sharding, fault
planning (port of ``repro.dist``), on ``torch.distributed``'s ``DeviceMesh``
and ``DTensor``.

  sharding.py      ShardingPlan + param/cache/input PartitionSpec rules with
                   divisibility-checked fallback to replication, and their
                   DTensor placements on a mesh.
  act_sharding.py  Activation batch-axis constraints that are exact no-ops
                   outside an explicit mesh context (single-device tests and
                   the serving engine never pay for them).
  fault.py         Policy layer for degraded fleets: which pods to shed,
                   what mesh to rebuild, and the recovery step narrative.
  dtensor.py       What the model's layers need to run on DTensors: mixed
                   plain operands, the kernels' operands laid out for
                   ``local_map``, and op counts at global shapes.
"""
from repro_torch.dist.act_sharding import constrain_batch, use_activation_sharding
from repro_torch.dist.fault import POD_CHIPS, FleetState, plan_mesh, plan_recovery
from repro_torch.dist.sharding import (
    ShardingPlan,
    cache_pspecs,
    input_pspecs,
    param_pspecs,
)

__all__ = [
    "ShardingPlan",
    "param_pspecs",
    "cache_pspecs",
    "input_pspecs",
    "constrain_batch",
    "use_activation_sharding",
    "POD_CHIPS",
    "FleetState",
    "plan_mesh",
    "plan_recovery",
]
