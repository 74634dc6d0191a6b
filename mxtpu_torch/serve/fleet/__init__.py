"""Fleet control plane, the port of ``mxtpu.serve.fleet``: multi-model,
multi-tenant serving over the gateway — named-model routing, SLO-driven
chip arbitration between per-model pools, priority classes, live
checkpoint hot-swap, session affinity, and the train→serve deployment
flywheel (publish → canary → promote/auto-rollback with chip lending)
over the port's checkpoint store (``mxtpu_torch.checkpoint``)."""
from .arbiter import ArbiterPolicy, FleetArbiter, TrainingTenant
from .fleet import FleetGateway, FleetPool, ModelSpec
from .flywheel import FlywheelController

__all__ = ["ArbiterPolicy", "FleetArbiter", "FleetGateway",
           "FleetPool", "FlywheelController", "ModelSpec",
           "TrainingTenant"]
