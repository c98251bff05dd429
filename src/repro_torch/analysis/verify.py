"""Plan verifier: run a ``CompiledDHM`` against the invariant registry.

The counterpart of ``repro.analysis.verify``. The reference interprets a
plan abstractly (``jax.eval_shape`` / ``jax.make_jaxpr``) and executes
no FLOPs; PyTorch has no abstract trace of the port's kernels, which are
opaque launches of hand-written CUDA. So the port runs the plan, on its
own device and at a tiny batch, and reads what happened:

- the ``plan`` scope runs each stage body on one zero frame of its
  declared input, and the head on one of the last stage's output;
- the ``resource`` scope costs the plan's fusion groups on the host, as
  the reference does, and on a card plan reads the shared memory each
  launch of the structure probe requested (V203);
- the ``pipeline`` scope reads a :class:`PipelineProbe`: the Engine's
  mesh-rung closure (the plan's pipelined runner and head; on a card
  plan its CUDA graph, replayed once) run on zero frames on a stage mesh
  (:func:`make_pipeline_probe`), with the edge transfers it logged on the
  probing thread; with no probe it finds nothing, as the reference's;
- the ``structure`` scope runs one probe of ``batch`` (2) zero frames
  through the stages and the head, on the calling thread, under a
  ``TorchDispatchMode`` that logs every aten op (its name, the dtypes it
  made, whether it ran inside a kernel wrapper, whether it moved data to
  the host) and with the kernels' ``probe`` log open, which records each
  kernel dispatch and each launch with the shared memory it requested.
  Both logs belong to the probing thread, so another thread's launches
  (a router serving other tenants while it verifies a swap) never enter
  the counts. On a card plan the scope also captures the plan's jitted
  closure (``jitted_forward()``, a CUDA graph) at the probe batch, which
  no host read between the kernels survives (V005), and calls the
  donating closure on its own input buffer with the op log open, to see
  that no device copy precedes the replay (V006,
  :meth:`ProbeContext.lower_donated`).

``verify_plan`` returns findings; ``check_plan`` (what
``CompiledDHM.self_check`` delegates to) raises ``PlanCheckError``
carrying the failed invariant IDs, so the serving engine's rung probe,
the router's swap and breaker probes and the tests enforce one registry.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.invariants import REGISTRY, SCOPES
from repro_torch.kernels import probe

# Ops that hand a value to the host (a read of a device scalar).
_HOST_READ_OPS = frozenset({"aten::item", "aten::_local_scalar_dense", "aten::is_nonzero"})


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One aten op the structure probe saw."""

    phase: str  # "features" | "head"
    name: str  # schema name, e.g. "aten::round"
    inside: bool  # ran inside a kernel wrapper's dispatch (the kernel's own)
    float_dtypes: tuple  # dtypes of the floating-point tensors it made
    to_host: bool  # read a value to the host or copied a card tensor to the CPU


@dataclasses.dataclass
class StructureTrace:
    """What one structure probe of a plan dispatched."""

    stage_dtypes: list  # dtype at each stage boundary
    logits_dtype: torch.dtype
    ops: list  # OpRecord per aten op
    dispatches: list  # (phase, kernel name, plain version?) per wrapper dispatch
    launches: list  # (phase, kernel name, shared-memory bytes) per launch on the card

    def phase_ops(self, phase: str) -> list:
        return [op for op in self.ops if op.phase == phase]

    def phase_dispatches(self, phase: str) -> list:
        return [d for d in self.dispatches if d[0] == phase]

    def phase_launches(self, phase: str) -> list:
        return [l for l in self.launches if l[0] == phase]


class _OpLog(TorchDispatchMode):
    """Logs every aten op of the thread that entered it."""

    def __init__(self, log):
        super().__init__()
        self.log = log
        self.ops: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
        ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        to_host = name in _HOST_READ_OPS or (
            any(t.device.type == "cuda" for t in ins)
            and any(t.device.type == "cpu" for t in outs)
        )
        self.ops.append(OpRecord(
            phase=self.log.phase, name=name, inside=self.log.depth > 0,
            float_dtypes=tuple(t.dtype for t in outs if t.is_floating_point()),
            to_host=to_host,
        ))
        return out


@dataclasses.dataclass(frozen=True)
class DonationReport:
    """What :meth:`ProbeContext.lower_donated` saw of
    ``jitted_forward(donate=True)``: the closure's declared flag and, on
    a card plan, the device copies (``aten::copy_``) a call on the
    closure's own input buffer made before its replay (None on a CPU
    plan, whose closure is eager)."""

    declared: bool
    input_copies: Optional[int] = None


@dataclasses.dataclass
class PipelineProbe:
    """One run of a plan's pipelined runner plus the EdgePlan it must
    realize: what the pipeline-scope invariants inspect. The reference's
    holds the traced jaxpr; the port's holds what the run logged."""

    transfers: list  # (edge class, (src, dst) stages, buffer shape) per hand-off
    launches: list  # (phase, kernel name, shared-memory bytes) per launch on the card
    edge_plan: object
    cfg: object
    mb_local: int  # per-slot µbatch rows each transfer moves


class ProbeContext:
    """One plan under verification, with its probe runs cached: the
    argument every invariant check receives."""

    def __init__(self, plan, *, where: str = "", batch: int = 2,
                 pipeline: Optional[PipelineProbe] = None):
        self.plan = plan
        self.batch = batch
        self.where = where or getattr(getattr(plan, "topo", None), "name", "plan")
        self.pipeline = pipeline
        self._trace: Optional[StructureTrace] = None
        self._capture_error: Optional[str] = None
        self._captured = False
        self._donated: Optional[DonationReport] = None

    # -- finding constructors ------------------------------------------------

    def error(self, rule: str, message: str) -> Finding:
        return Finding(
            rule=rule, name=REGISTRY[rule].name, severity="error",
            message=message, where=self.where,
        )

    def warning(self, rule: str, message: str) -> Finding:
        return Finding(
            rule=rule, name=REGISTRY[rule].name, severity="warning",
            message=message, where=self.where,
        )

    # -- probe runs ------------------------------------------------------------

    @property
    def on_card(self) -> bool:
        """Whether the plan runs the kernels (a CUDA plan) rather than
        their plain versions (a CPU plan)."""
        return torch.device(self.plan.device).type == "cuda"

    def run(self, fn, *args):
        """``fn(*args)`` on the plan's device, as the engine runs it."""
        from repro_torch.core.dhm.engine import on_device

        with torch.inference_mode(), on_device(torch.device(self.plan.device)):
            out = fn(*args)
            if self.on_card:
                torch.cuda.synchronize(self.plan.device)
            return out

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(tuple(shape), dtype=torch.float32, device=self.plan.device)

    def trace(self) -> StructureTrace:
        """The structure probe: ``batch`` zero frames through the stages
        (one by one, as ``features`` runs them, so each boundary can be
        read) and the head, with both logs open."""
        if self._trace is None:
            plan = self.plan
            h, w = plan.topo.input_shape
            x = self.zeros((self.batch, h, w, plan.topo.input_channels))
            dtypes = []

            def forward(x):
                with probe.recording() as log, _OpLog(log) as ops:
                    log.phase = "features"
                    for st in plan.stages:
                        x = st.fn(plan.stage_params(st.index), x)
                        dtypes.append(x.dtype)
                    log.phase = "head"
                    out = plan.head_fn(x)
                return out, log, ops

            out, log, ops = self.run(forward, x)
            self._trace = StructureTrace(
                stage_dtypes=dtypes, logits_dtype=out.dtype, ops=ops.ops,
                dispatches=log.dispatches, launches=log.launches,
            )
        return self._trace

    def _probe_shape(self) -> tuple:
        h, w = self.plan.topo.input_shape
        return (self.batch, h, w, self.plan.topo.input_channels)

    def capture_error(self) -> Optional[str]:
        """On a card plan: capture ``jitted_forward()`` at the probe batch
        and return the error that stopped the capture (CUDA's message), or
        None when it captured. None on a CPU plan, which captures
        nothing."""
        if not self._captured:
            self._captured = True
            fwd = getattr(self.plan, "jitted_forward", None)
            if self.on_card and fwd is not None:
                try:
                    self.run(fwd(), self.zeros(self._probe_shape()))
                except Exception as e:  # noqa: BLE001 — the finding carries it
                    self._capture_error = f"{type(e).__name__}: {e}"
        return self._capture_error

    def lower_donated(self) -> Optional[DonationReport]:
        """The donation ``jitted_forward(donate=True)`` really makes: on a
        card plan its graph is captured at the probe batch and called on
        its own input buffer with the op log open, counting the device
        copies before the replay; on a CPU plan the closure's declared
        flag alone. None when the plan has no such surface."""
        if self._donated is None:
            fwd = getattr(self.plan, "jitted_forward", None)
            if fwd is None:
                return None
            fwd = fwd(donate=True)
            declared = bool(getattr(fwd, "donate", False))
            copies = None
            if self.on_card and hasattr(fwd, "input_buffer"):

                def call():
                    with fwd.lock:
                        buf = fwd.input_buffer(self._probe_shape())
                        with probe.recording() as log, _OpLog(log) as ops:
                            fwd(buf)
                    return ops.ops

                copies = sum(op.name == "aten::copy_" for op in self.run(call))
            self._donated = DonationReport(declared=declared, input_copies=copies)
        return self._donated


def _resolve_scopes(scopes, ids) -> tuple:
    scopes = SCOPES if scopes is None else tuple(scopes)
    unknown = set(scopes) - set(SCOPES)
    if unknown:
        raise ValueError(f"unknown scopes {sorted(unknown)}; have {SCOPES}")
    if ids is not None:
        missing = sorted(set(ids) - set(REGISTRY))
        if missing:
            raise NotImplementedError(
                f"the port has no invariant {', '.join(missing)}; it has "
                f"{sorted(REGISTRY)}"
            )
    return scopes


def verify_plan(
    plan,
    *,
    scopes=None,
    ids=None,
    where: str = "",
    batch: int = 2,
    pipeline: Optional[PipelineProbe] = None,
    traces: Optional[list] = None,
) -> list:
    """Run the invariant registry against one plan.

    ``scopes`` restricts to registry scopes (default: all four, ``plan``,
    ``structure``, ``resource`` and ``pipeline``; the last reads
    ``pipeline``, a :class:`PipelineProbe`); asking for an unknown scope
    raises ``ValueError``, for an ID the port does not have
    ``NotImplementedError`` — it never passes quietly. ``ids`` restricts
    to specific invariant IDs. Returns the findings (possibly empty).
    Runs the plan on its device: the plan scope on one frame, the
    structure probe (which V203 also reads) on ``batch`` frames. Where a
    check ran the structure probe, its :class:`StructureTrace` is
    appended to ``traces`` if a list is given.
    """
    scopes = _resolve_scopes(scopes, ids)
    ctx = ProbeContext(plan, where=where, batch=batch, pipeline=pipeline)
    findings = []
    for inv in REGISTRY.values():
        if inv.scope not in scopes:
            continue
        if ids is not None and inv.id not in ids:
            continue
        findings.extend(inv.fn(ctx))
    if traces is not None and ctx._trace is not None:
        traces.append(ctx._trace)
    return findings


def check_plan(plan) -> None:
    """The serving-fitness probe: run the ``plan``-scope invariants and
    raise ``PlanCheckError`` (carrying the failed invariant IDs) on any
    error — what ``CompiledDHM.self_check`` and the engine's rung
    activation enforce."""
    findings = [f for f in verify_plan(plan, scopes=("plan",)) if f.is_error]
    if findings:
        from repro_torch.core.dhm.compiler import PlanCheckError

        ids = sorted({f.rule for f in findings})
        detail = "; ".join(f.message for f in findings)
        raise PlanCheckError(
            f"{getattr(plan.topo, 'name', 'plan')}: plan check failed "
            f"[{', '.join(ids)}]: {detail}",
            invariants=ids,
        )


def make_pipeline_probe(
    plan, *, mesh=None, n_microbatches: Optional[int] = None,
    microbatch: int = 2, overlap: bool = False, edge_mode: str = "auto",
) -> PipelineProbe:
    """Build the Engine's mesh-rung closure for the plan on a stage mesh
    (``engine._mesh_forward``: the pipelined runner and the head) and run
    it once on zero frames, on the probing thread with the kernels' log
    open; returns the :class:`PipelineProbe` the pipeline-scope
    invariants consume. On a card plan the closure is the rung's CUDA
    graph, captured before the log opens, so the log holds the launches
    and edge transfers of one replay: what the rung serves. ``mesh``
    defaults to an ``n_stages`` stage mesh on the plan's device type (a
    CPU mesh needs no forced device count)."""
    from repro_torch.core.dhm.engine import JittedForward, _mesh_forward, on_device
    from repro_torch.core.dhm.pipeline import PipelineConfig
    from repro_torch.launch.mesh import make_mesh

    S = plan.n_stages
    dev = torch.device(plan.device)
    if mesh is None:
        mesh = make_mesh((S,), ("stage",), device=dev.type)
    M = n_microbatches if n_microbatches is not None else max(S, 2)
    cfg = PipelineConfig(
        S, M, stage_axis=mesh.axis_names[0], overlap=overlap,
        edge_mode=edge_mode,
    )
    runner, fwd = _mesh_forward(plan, mesh, cfg, microbatch)
    h, w = plan.topo.input_shape
    frames = torch.zeros((M * microbatch, h, w, plan.topo.input_channels),
                         dtype=torch.float32, device=dev)
    with on_device(dev):
        if isinstance(fwd, JittedForward):
            fwd.input_buffer(tuple(frames.shape))  # on the card, the capture
        with probe.recording() as log:
            fwd(frames)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    return PipelineProbe(
        transfers=list(log.transfers), launches=list(log.launches),
        edge_plan=runner.edge_plan, cfg=cfg, mb_local=microbatch,
    )
