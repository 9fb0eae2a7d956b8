"""Fault-tolerance policy layer: re-mesh planning under pod degradation (a
copy of ``repro.dist.fault``: the fleet controller records this plan as its
recovery narrative, so its constants stay the reference's).

Pure policy, no jax device state: given per-pod healthy-chip counts, decide
which pods to shed, what mesh rectangle the survivors can all support, and
the ordered recovery steps. The mechanism layer (``launch/mesh.make_mesh``,
``launch/elastic.py``) builds whatever this module plans — the same
divisibility-fallback sharding rules then re-resolve every dim on the
smaller mesh (DESIGN.md §dist).

Production fleet: pods of 16x16 = 256 chips, meshed as
('pod', 'data', 'model'); the model axis is kept at 16 (intra-pod ICI) and
degradation shrinks the data axis to the largest rectangle every surviving
pod can host. Pods below 50% health cost more in collective stragglers than
they contribute and are shed outright.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Tuple

POD_CHIPS = 256  # healthy pod: 16 x 16
MODEL_AXIS_SIZE = 16  # fixed: tensor parallelism stays intra-pod
HEALTH_FLOOR = 0.5  # pods below this health fraction are shed


@dataclass(frozen=True)
class FleetState:
    """Healthy-chip count per pod (index = pod id)."""

    pods: Tuple[int, ...]
    pod_chips: int = POD_CHIPS


@dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    dropped_pods: Tuple[int, ...] = ()

    @property
    def chips(self) -> int:
        return math.prod(self.shape)


def plan_mesh(fleet: FleetState) -> MeshPlan:
    """Largest-common-rectangle mesh over the surviving pods.

    Healthy 2-pod fleet -> (2, 16, 16) over ('pod', 'data', 'model');
    a partially degraded pod clamps the data axis for everyone (SPMD needs a
    uniform per-pod rectangle); sub-50% pods are shed; an all-dead fleet
    raises RuntimeError."""
    floor = fleet.pod_chips * HEALTH_FLOOR
    kept = [i for i, c in enumerate(fleet.pods) if c >= floor]
    dropped = tuple(i for i in range(len(fleet.pods)) if i not in kept)
    if not kept:
        raise RuntimeError(
            f"no pod is >= {HEALTH_FLOOR:.0%} healthy (pods={fleet.pods}); "
            "cannot plan a mesh"
        )
    rows = min(
        fleet.pod_chips // MODEL_AXIS_SIZE,
        min(fleet.pods[i] for i in kept) // MODEL_AXIS_SIZE,
    )
    if rows < 1:
        raise RuntimeError(
            f"surviving pods cannot host a single {MODEL_AXIS_SIZE}-chip "
            f"model row (pods={fleet.pods}); cannot plan a mesh"
        )
    if len(kept) == 1:
        return MeshPlan(
            shape=(rows, MODEL_AXIS_SIZE),
            axes=("data", "model"),
            dropped_pods=dropped,
        )
    return MeshPlan(
        shape=(len(kept), rows, MODEL_AXIS_SIZE),
        axes=("pod", "data", "model"),
        dropped_pods=dropped,
    )


@dataclass(frozen=True)
class RecoveryPlan:
    """Ordered (action, detail) steps to move the fleet onto ``mesh``."""

    fleet: FleetState
    mesh: MeshPlan
    steps: Tuple[Tuple[str, str], ...]

    def describe(self) -> List[str]:
        return [f"{i}. {a}: {d}" for i, (a, d) in enumerate(self.steps, 1)]


def plan_recovery(fleet: FleetState) -> RecoveryPlan:
    """Recovery narrative for a degraded fleet, consumable by
    ``launch/elastic.py``: checkpoint first (the old mesh can still serve a
    save), shed unhealthy pods, then restart onto the planned mesh."""
    mesh = plan_mesh(fleet)
    steps: List[Tuple[str, str]] = [
        ("drain", "stop admitting new requests; finish in-flight decode steps"),
        ("checkpoint", "save the latest complete step from the surviving hosts"),
    ]
    if mesh.dropped_pods:
        health = ", ".join(
            f"pod {i}: {fleet.pods[i]}/{fleet.pod_chips}" for i in mesh.dropped_pods
        )
        steps.append(
            ("shed pods", f"{mesh.dropped_pods} below {HEALTH_FLOOR:.0%} health ({health})")
        )
    steps.append(
        (
            "reset_for_restart",
            f"rebuild mesh {mesh.shape} over {mesh.axes} "
            f"({mesh.chips} chips) and restore the checkpoint",
        )
    )
    return RecoveryPlan(fleet=fleet, mesh=mesh, steps=tuple(steps))
