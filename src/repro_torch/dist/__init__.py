"""Distribution layer of the port: so far only the fault-planning policy
(`fault.py`) that the fleet controller's recovery narrative runs. The
sharding modules of ``repro.dist`` are not ported yet."""
from repro_torch.dist.fault import POD_CHIPS, FleetState, plan_mesh, plan_recovery

__all__ = ["POD_CHIPS", "FleetState", "plan_mesh", "plan_recovery"]
