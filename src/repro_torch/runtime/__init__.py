"""Training runtime: fault-tolerant driver (checkpoint/restart),
straggler detection, elastic re-meshing (the counterpart of
``repro.runtime``)."""
from repro_torch.runtime.driver import (
    ElasticMesh,
    FaultInjector,
    NodeFailure,
    ResilientTrainer,
    StragglerMonitor,
)

__all__ = [
    "ElasticMesh",
    "FaultInjector",
    "NodeFailure",
    "ResilientTrainer",
    "StragglerMonitor",
]
