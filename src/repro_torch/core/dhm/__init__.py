"""Direct Hardware Mapping (DHM) core of the port, organised as the
reference's compiler pipeline:

    CNNTopology --(graph)--> DPN actor graph --(mapping)--> stages
               --(fusion)--> fusion groups --(compiler)--> CompiledDHM plan
               --(engine)--> single-device forward / serving Engine
               --(pipeline)--> the stages on a mesh of slots

``graph``, ``mapping`` and ``fusion`` are copies of the reference's pure
Python planners; ``compiler`` emits closures over the hand-written CUDA
kernels; ``pipeline`` streams a plan's stages through a mesh of slots
(one stream per stage on the card, GPipe schedule, exact-shape or boxed
edges); ``engine`` serves a plan on one device or, on its ``mesh`` rung,
through the pipeline; ``throughput`` prices and tunes the pipeline and
carries the paper's Table-4 law; ``resources`` is the paper's Tables 2-3
FPGA resource model; ``faults`` injects
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
    build_plan_pipeline,
    forward,
    pipeline_spec,
    run_pipelined,
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
from repro_torch.core.dhm.graph import (
    Actor,
    ActorKind,
    DataflowGraph,
    cnn_to_dpn,
    layer_costs_to_dpn,
)
from repro_torch.core.dhm.mapping import StageAssignment, balance_report, partition_stages
from repro_torch.core.dhm.pipeline import (
    EDGE_MODES,
    CollectiveTimeout,
    EdgePlan,
    PipelineConfig,
    PipelinedRunner,
    StageIOSpec,
    build_pipeline,
    call_with_timeout,
    pipeline_forward,
    plan_edges,
)
from repro_torch.core.dhm.resources import (
    CYCLONE_V_5CGXFC9E7,
    KINTEX7_XC7Z045,
    DeviceModel,
    MultiplierStrategy,
    ResourceReport,
    estimate_resources,
)
from repro_torch.core.dhm.throughput import (
    PipelineCostConstants,
    PipelineEstimate,
    PipelineTuning,
    ThroughputReport,
    autotune_pipeline,
    candidate_grid,
    dhm_throughput_gops,
    estimate_pipeline,
    fit_constants,
    load_sweep_measurements,
    pipeline_workload,
    streaming_throughput,
    sweep_sample,
)

__all__ = [
    "Actor",
    "ActorKind",
    "CYCLONE_V_5CGXFC9E7",
    "DataflowGraph",
    "DeviceModel",
    "EDGE_MODES",
    "EdgePlan",
    "KINTEX7_XC7Z045",
    "MultiplierStrategy",
    "PipelineConfig",
    "PipelineCostConstants",
    "PipelineEstimate",
    "PipelineTuning",
    "PipelinedRunner",
    "ResourceReport",
    "StageAssignment",
    "ThroughputReport",
    "autotune_pipeline",
    "balance_report",
    "build_pipeline",
    "build_plan_pipeline",
    "call_with_timeout",
    "candidate_grid",
    "cnn_to_dpn",
    "dhm_throughput_gops",
    "estimate_pipeline",
    "estimate_resources",
    "fit_constants",
    "layer_costs_to_dpn",
    "load_sweep_measurements",
    "partition_stages",
    "pipeline_forward",
    "pipeline_spec",
    "pipeline_workload",
    "plan_edges",
    "run_pipelined",
    "streaming_throughput",
    "sweep_sample",
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
