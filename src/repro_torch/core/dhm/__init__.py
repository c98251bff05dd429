"""Direct Hardware Mapping (DHM) core of the port, organised as the
reference's compiler pipeline:

    CNNTopology --(graph)--> DPN actor graph --(mapping)--> stages
               --(fusion)--> fusion groups --(compiler)--> CompiledDHM plan
               --(engine)--> single-device forward / serving Engine

``graph``, ``mapping`` and ``fusion`` are copies of the reference's pure
Python planners; ``compiler`` emits closures over the hand-written CUDA
kernels; ``engine`` serves a plan on one device.
"""
from repro_torch.core.dhm.compiler import (
    CompiledDHM,
    CompiledStage,
    PlanCheckError,
    QuantSpec,
    check_plan,
    compile_dhm,
    emit_conv_stage,
    validate_topology,
)
from repro_torch.core.dhm.engine import (
    BatchFailed,
    DeadlineExceeded,
    Engine,
    EngineStats,
    FlusherWedged,
    InvalidRequest,
    LadderExhausted,
    Rejected,
    Request,
    RequestError,
    Shed,
    forward,
)

__all__ = [
    "BatchFailed",
    "CompiledDHM",
    "CompiledStage",
    "DeadlineExceeded",
    "Engine",
    "EngineStats",
    "FlusherWedged",
    "InvalidRequest",
    "LadderExhausted",
    "PlanCheckError",
    "QuantSpec",
    "Rejected",
    "Request",
    "RequestError",
    "Shed",
    "check_plan",
    "compile_dhm",
    "emit_conv_stage",
    "forward",
    "validate_topology",
]
