"""Direct Hardware Mapping (DHM) core of the port, organised as the
reference's compiler pipeline:

    CNNTopology --(graph)--> DPN actor graph --(mapping)--> stages
               --(fusion)--> fusion groups --(compiler)--> CompiledDHM plan
               --(engine)--> single-device forward / serving Engine

``graph``, ``mapping`` and ``fusion`` are copies of the reference's pure
Python planners; ``compiler`` emits closures over the hand-written CUDA
kernels; ``engine`` serves a plan on one device; ``faults`` injects
deterministic, seed-driven failures through ``Engine(fault_plan=...)``,
scoped to a rung or a tenant; ``multitenant`` keeps N plans resident
behind one ``Router`` (per-tenant queues and SLOs, deficit-round-robin
scheduling, circuit breakers, verified hot swap with rollback).
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
from repro_torch.core.dhm.faults import (
    DelayedFlush,
    DeviceLoss,
    DispatchError,
    FaultPlan,
    InjectedDeviceLoss,
    InjectedDispatchError,
    InjectedFault,
    NaNActivation,
    StalledDispatch,
)
from repro_torch.core.dhm.multitenant import (
    CircuitBreaker,
    CircuitOpen,
    Router,
    SwapRejected,
    UnknownTenant,
)
from repro_torch.core.dhm.pipeline import CollectiveTimeout, StageIOSpec

__all__ = [
    "BatchFailed",
    "CircuitBreaker",
    "CircuitOpen",
    "CollectiveTimeout",
    "CompiledDHM",
    "CompiledStage",
    "DeadlineExceeded",
    "DelayedFlush",
    "DeviceLoss",
    "DispatchError",
    "Engine",
    "EngineStats",
    "FaultPlan",
    "FlusherWedged",
    "InjectedDeviceLoss",
    "InjectedDispatchError",
    "InjectedFault",
    "InvalidRequest",
    "LadderExhausted",
    "NaNActivation",
    "PlanCheckError",
    "QuantSpec",
    "Rejected",
    "Request",
    "RequestError",
    "Router",
    "Shed",
    "StageIOSpec",
    "StalledDispatch",
    "SwapRejected",
    "UnknownTenant",
    "check_plan",
    "compile_dhm",
    "emit_conv_stage",
    "forward",
    "validate_topology",
]
