"""The named invariant registry the plan verifier enforces.

The counterpart of ``repro.analysis.invariants``: the same IDs, names and
scopes, for all four scopes.

- ``plan`` (V3xx): serving-fitness checks — finite baked params,
  consistent stage IO geometry, stage bodies and head producing the
  shapes they promise, the serving surface present. This scope IS the
  ``check_plan`` rung probe: the serving engine, the router and the tests
  enforce one registry. The reference interprets the stage bodies and the
  head abstractly (``jax.eval_shape``); the port runs each on one zero
  frame on the plan's device.
- ``structure`` (V0xx): the reference traces a jaxpr and counts its
  primitives. The port runs one probe of 2 frames on the plan's device
  (``verify.ProbeContext.trace``) and counts what the probing thread
  dispatched: kernel dispatches and card launches from the kernels'
  ``probe`` log, aten ops from a ``TorchDispatchMode``. An op that runs
  inside a kernel wrapper's dispatch is the kernel's own (on a CPU plan,
  the plain version's); the others are the glue between launches.
- ``resource`` (V2xx): working-set fit. Each check keeps the reference's
  host-side costing of the VMEM working sets (``fusion.py``), so both
  packages give the same findings on the same plan (but for singleton
  groups, which V202 and V204 do not re-cost), and adds a Hopper
  part that runs only on a plan for the card: the shared memory each
  group's launches request (``CompiledDHM.card_smem``, recorded by
  ``compile_dhm``) against ``conv.SMEM_LIMIT``, the
  232,448 B a Hopper block may use, and against what ``conv.py`` sizes
  for the group today (``compiler.card_group_cost``). V203 reads the
  bytes each launch really requested, which the launchers log
  (``kernels/probe.py``).
- ``pipeline`` (V1xx): the reference reads the ``ppermute``s of the traced
  pipelined closure. The port runs the pipelined runner once on zero
  µbatches (``verify.make_pipeline_probe``) and reads the edge transfers
  it logged on the probing thread (``kernels/probe.py``): each hand-off's
  shape class, (source, destination) stages and buffer shape. A class's
  transfers play the part of the reference's one ``ppermute`` per class.
  With no probe given, the scope finds nothing, as the reference's.

Invariants self-gate as in the reference: a check that only the kernel
path has (V003, V007, V203) returns no findings on a CPU plan, as the
reference's kernel-structure checks return none on a non-Pallas
backend. V001 has no observable counterpart in PyTorch; it is
registered, and its docstring says why it finds nothing. V006 reads the
port's donation, a static input buffer handed over to the closure's CUDA
graph (``core/dhm/engine.py``, ``JittedForward``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

import torch

from repro_torch.kernels.stream_conv.conv import MAX_PYRAMID_LAYERS, SMEM_LIMIT, bwd_launches

SCOPES = ("plan", "structure", "resource", "pipeline")


@dataclasses.dataclass(frozen=True)
class Invariant:
    id: str
    name: str
    scope: str
    doc: str
    fn: Callable


REGISTRY: Dict[str, Invariant] = {}


def invariant(id: str, *, name: str, scope: str):
    """Register an invariant check under a stable ID."""
    if scope not in SCOPES:
        raise ValueError(f"scope must be one of {SCOPES}, got {scope!r}")

    def deco(fn):
        if id in REGISTRY:
            raise ValueError(f"duplicate invariant id {id!r}")
        REGISTRY[id] = Invariant(
            id=id, name=name, scope=scope, doc=fn.__doc__ or "", fn=fn
        )
        return fn

    return deco


def by_scope(*scopes: str):
    return [inv for inv in REGISTRY.values() if inv.scope in scopes]


def card_cost(plan, g, elem_bytes=None) -> tuple:
    """``compiler.card_group_cost`` of fusion group ``g`` of ``plan``:
    (launches, shared-memory bytes per block, parts), at the plan's slab
    width unless ``elem_bytes`` is given."""
    from repro_torch.core.dhm.compiler import card_group_cost
    from repro_torch.core.dhm.fusion import plan_elem_bytes

    eb = plan_elem_bytes(plan.quant) if elem_bytes is None else elem_bytes
    return card_group_cost(plan.topo, tuple(g.layers), g.block_rows, elem_bytes=eb,
                           block_r=plan.block_r)


def planned_launches(plan) -> int:
    """The kernel launches the card makes for ``plan.features``: one per
    multi-layer fusion group (the pyramid kernel), and for each singleton
    the column strips times the channel slices the single-layer launcher
    plans for it (``conv.fused_plan`` over the SAME-padded frame)."""
    return sum(card_cost(plan, g)[0] for g in plan.fusion_groups)


def planned_backward_launches(plan, *, frame_grad: bool = False) -> int:
    """The kernel launches the card makes for the gradient of
    ``plan.features``: ``conv.bwd_launches`` of each fusion group, whose
    input needs a gradient in every group after the first, and in the
    first where ``frame_grad``."""
    return sum(bwd_launches(len(g.layers), i > 0 or frame_grad)
               for i, g in enumerate(plan.fusion_groups))


# ---------------------------------------------------------------------------
# plan scope (V3xx) — the check_plan rung-probe set


@invariant("V301", name="finite-params", scope="plan")
def _finite_params(ctx):
    """Every baked parameter is finite — NaN/Inf weights must never reach
    a serving rung. The port checks the FC head's baked parameters too,
    beside the conv layers the reference checks."""
    out = []
    for group, params in (("conv", ctx.plan.conv_params),
                          ("fc", getattr(ctx.plan, "fc_params", ()))):
        for li, p in enumerate(params):
            for k, v in p.items():
                if not bool(torch.isfinite(v).all()):
                    out.append(ctx.error(
                        "V301",
                        f"{group} layer {li} parameter {k!r} contains non-finite "
                        "values — the plan cannot serve",
                    ))
    return out


@invariant("V302", name="io-chain", scope="plan")
def _io_chain(ctx):
    """StageIOSpec geometry is present, starts at the topology input, and
    chains stage-to-stage."""
    plan = ctx.plan
    ios = [st.io for st in plan.stages]
    if any(io is None for io in ios):
        return [ctx.error("V302", "plan stages miss StageIOSpec geometry")]
    out = []
    h, w = plan.topo.input_shape
    if tuple(ios[0].in_shape) != (h, w, plan.topo.input_channels):
        out.append(ctx.error(
            "V302",
            f"stage 0 input {ios[0].in_shape} does not match the topology "
            f"input {(h, w, plan.topo.input_channels)}",
        ))
    for s in range(len(ios) - 1):
        if tuple(ios[s].out_shape) != tuple(ios[s + 1].in_shape):
            out.append(ctx.error(
                "V302",
                f"stage {s} output {ios[s].out_shape} does not chain into "
                f"stage {s + 1} input {ios[s + 1].in_shape}",
            ))
    return out


@invariant("V303", name="stage-io-shape", scope="plan")
def _stage_io_shape(ctx):
    """Each emitted stage body, run on one zero frame of its declared
    input on the plan's device (the reference interprets it abstractly),
    produces exactly the shape its StageIOSpec promises."""
    plan = ctx.plan
    out = []
    for st in plan.stages:
        if st.io is None:
            continue  # V302 reports the missing geometry
        try:
            got = ctx.run(st.fn, plan.stage_params(st.index),
                          ctx.zeros((1,) + tuple(st.io.in_shape)))
        except Exception as e:  # noqa: BLE001 — surfaced as a finding
            out.append(ctx.error(
                "V303",
                f"stage {st.index} body fails to run on its declared input "
                f"{st.io.in_shape}: {e}",
            ))
            continue
        if tuple(got.shape[1:]) != tuple(st.io.out_shape):
            out.append(ctx.error(
                "V303",
                f"stage {st.index} body produces {tuple(got.shape[1:])}, "
                f"but its StageIOSpec promises {tuple(st.io.out_shape)}",
            ))
    return out


@invariant("V304", name="head-io", scope="plan")
def _head_io(ctx):
    """The FC head takes the final feature shape and yields rank-2 float
    logits: its baked widths chain from the flattened features to the
    topology's classes, and it runs on one zero frame of the final
    feature shape (the reference interprets it abstractly)."""
    plan = ctx.plan
    last = plan.stages[-1].io
    if last is None:
        return []
    width = math.prod(last.out_shape)
    for i, p in enumerate(getattr(plan, "fc_params", ())):
        if p["w"].shape[0] != width or tuple(p["b"].shape) != (p["w"].shape[1],):
            return [ctx.error(
                "V304", f"fc layer {i} {tuple(p['w'].shape)} does not take width {width}"
            )]
        width = p["w"].shape[1]
    try:
        got = ctx.run(plan.head_fn, ctx.zeros((1,) + tuple(last.out_shape)))
    except Exception as e:  # noqa: BLE001 — surfaced as a finding
        return [ctx.error(
            "V304",
            f"head fails to run on the final feature shape "
            f"{tuple(last.out_shape)}: {e}",
        )]
    if got.ndim != 2 or got.shape[0] != 1:
        return [ctx.error(
            "V304",
            f"head produces shape {tuple(got.shape)}; expected rank-2 "
            "(batch, n_classes) logits",
        )]
    if got.shape[1] != plan.topo.n_classes:
        return [ctx.error(
            "V304",
            f"head ends at width {got.shape[1]}, expected {plan.topo.n_classes} classes",
        )]
    return []


@invariant("V305", name="serving-surface", scope="plan")
def _serving_surface(ctx):
    """The plan exposes the full surface the serving layer consumes —
    ``topo.input_shape``/``input_channels`` (frame geometry), callable
    ``features`` and ``head_fn``, and at least one stage — so a hot-swap
    target missing any of it is rejected by ``verify_plan`` instead of
    crashing the tenant's warmup dispatch."""
    plan = ctx.plan
    out = []
    topo = getattr(plan, "topo", None)
    shape = getattr(topo, "input_shape", None)
    if (
        topo is None
        or not isinstance(shape, (tuple, list))
        or len(shape) != 2
        or not isinstance(getattr(topo, "input_channels", None), int)
    ):
        out.append(ctx.error(
            "V305",
            "plan topology does not declare the serving frame geometry "
            "(input_shape pair + integer input_channels)",
        ))
    if not callable(getattr(plan, "features", None)):
        out.append(ctx.error(
            "V305", "plan has no callable ``features`` extractor"
        ))
    if not callable(getattr(plan, "head_fn", None)):
        out.append(ctx.error(
            "V305", "plan has no callable ``head_fn``"
        ))
    if not getattr(plan, "stages", ()):
        out.append(ctx.error("V305", "plan has no stages"))
    return out


# ---------------------------------------------------------------------------
# structure scope (V0xx)


@invariant("V001", name="one-dot-per-conv-layer", scope="structure")
def _one_dot_per_layer(ctx):
    """The reference counts one ``dot_general`` per conv layer in its
    trace. The port's conv GEMMs live inside hand-written CUDA kernels,
    which PyTorch sees as opaque launches: no op is visible to count, so
    this check has no observable counterpart and finds nothing. The
    kernels' one implicit GEMM per layer is checked on the card against
    the plain versions instead."""
    return []


@invariant("V002", name="one-pallas-call-per-group", scope="structure")
def _one_launch_per_group(ctx):
    """Each fusion group is ONE kernel dispatch — the no-external-memory
    dataflow across fused layer boundaries. On the card the launches
    are counted too: one per multi-layer group, and for a singleton the
    column strips and channel slices its launcher plans."""
    plan = ctx.plan
    tr = ctx.trace()
    n_groups = len(plan.fusion_groups)
    convs = [d for d in tr.phase_dispatches("features") if d[1].startswith("stream_conv")]
    out = []
    if len(convs) != n_groups:
        out.append(ctx.error(
            "V002",
            f"features made {len(convs)} conv kernel dispatches for {n_groups} "
            "fusion groups — expected exactly one per group",
        ))
    if ctx.on_card:
        want = planned_launches(plan)
        got = len(tr.phase_launches("features"))
        if got != want:
            out.append(ctx.error(
                "V002",
                f"features launched {got} kernels on the card; the plan's "
                f"{n_groups} fusion groups plan {want} (strips included)",
            ))
    return out


@invariant("V003", name="no-conv-primitive", scope="structure")
def _no_conv_primitive(ctx):
    """No ``aten::convolution`` (or any of its forms) runs in the features
    of a plan for the card — the DHM lowering maps convolutions onto the
    streaming kernels, never onto cuDNN. A CPU plan's plain versions are
    convolutions by design: no findings there."""
    if not ctx.on_card:
        return []
    convs = [op.name for op in ctx.trace().phase_ops("features")
             if op.name.startswith("aten::conv") or "convolution" in op.name]
    if convs:
        return [ctx.error(
            "V003",
            f"features ran {len(convs)} convolution op(s) {sorted(set(convs))} — "
            "the plan fell back to the library convolution",
        )]
    return []


@invariant("V004", name="dtype-drift", scope="structure")
def _dtype_drift(ctx):
    """Every stage boundary and the logits are float32, and so is every
    floating-point tensor the glue between the kernels makes (features
    and head; no float64/bfloat16 drift). Inside a kernel's dispatch the
    plain versions may sum integer codes in float64, which is exact."""
    tr = ctx.trace()
    out = []
    bad = sorted({str(d) for d in tr.stage_dtypes if d != torch.float32})
    if bad:
        out.append(ctx.error("V004", f"stage boundaries carry {bad}, not float32"))
    if tr.logits_dtype != torch.float32:
        out.append(ctx.error("V004", f"the logits are {tr.logits_dtype}, not float32"))
    glue = sorted({str(d) for op in tr.ops if not op.inside
                   for d in op.float_dtypes if d != torch.float32})
    if glue:
        out.append(ctx.error(
            "V004", f"the glue between the kernels makes non-float32 float dtypes: {glue}",
        ))
    return out


@invariant("V005", name="no-host-transfer", scope="structure")
def _no_host_transfer(ctx):
    """Nothing in the forward (features and head, as the reference's
    closure) reads a value to the host (``aten::item`` /
    ``_local_scalar_dense``) or copies a card tensor to the CPU —
    nothing may stall the serving hot path on a host round-trip. On a
    card plan the jitted closure must also capture as a CUDA graph,
    which no host read between the kernels survives: a capture that
    fails is an error carrying CUDA's message."""
    seen = {}
    for op in ctx.trace().ops:
        if op.to_host:
            seen[op.name] = seen.get(op.name, 0) + 1
    out = []
    if seen:
        out.append(ctx.error(
            "V005", f"the forward moves data to the host: {seen}",
        ))
    err = ctx.capture_error()
    if err is not None:
        out.append(ctx.error(
            "V005", f"capturing jitted_forward() as a CUDA graph failed: {err}",
        ))
    return out


@invariant("V006", name="donation-declared", scope="structure")
def _donation_declared(ctx):
    """``jitted_forward(donate=True)`` really takes its input by donation:
    the closure declares ``donate``, and on a card plan a call with its
    own input buffer (``input_buffer``, where the serving engine stages
    each batch) makes no device copy before the graph's replay. Either
    failing means the donate flag was dropped. A plan with no
    ``jitted_forward`` surface finds nothing, as in the reference."""
    rep = ctx.lower_donated()
    if rep is None:
        return []
    if not rep.declared:
        return [ctx.error(
            "V006",
            "jitted_forward(donate=True) returned a closure that does not "
            "donate its input — the donation was dropped",
        )]
    if rep.input_copies:
        return [ctx.error(
            "V006",
            f"the donating closure copied its own input buffer "
            f"{rep.input_copies} time(s) before the replay — the donation "
            "was dropped",
        )]
    return []


@invariant("V007", name="in-kernel-stream-quant", scope="structure")
def _in_kernel_stream_quant(ctx):
    """With ``act_bits`` set, the feature-stream quantization runs INSIDE
    the kernels' epilogues, not as separate ops between launches: the
    features' glue holds no ``aten::round``. Int8 plans quantize each
    group's INPUT frame to 1-byte codes before its launch: exactly one
    round per fusion group is legal there, and no more. The kernel path
    only: a CPU plan's plain versions quantize with ops by design."""
    plan = ctx.plan
    if not ctx.on_card or plan.quant.act_bits is None:
        return []
    rounds = sum(1 for op in ctx.trace().phase_ops("features")
                 if not op.inside and op.name == "aten::round")
    int8 = bool(getattr(plan.quant, "int8_compute", False))
    allowed = len(plan.fusion_groups) if int8 else 0
    if rounds != allowed:
        return [ctx.error(
            "V007",
            f"{rounds} stream-quant round(s) between the kernels — expected "
            f"{allowed} ({'one input-quantize per fusion group' if int8 else 'none'})",
        )]
    return []


@invariant("V008", name="integer-conv-compute", scope="structure")
def _integer_conv_compute(ctx):
    """An ``int8_compute`` plan really computes in integers: every conv
    dispatch of its features goes to an int8 kernel (``*_int8``: int8
    codes, int32 accumulation; on a CPU plan the plain versions' integer
    rendering) — no float kernel under an integer contract."""
    plan = ctx.plan
    if not bool(getattr(plan.quant, "int8_compute", False)):
        return []
    convs = [d for d in ctx.trace().phase_dispatches("features")
             if d[1].startswith("stream_conv")]
    if not convs:
        return [ctx.error("V008", "int8 plan's features dispatch no conv kernel")]
    return [
        ctx.error(
            "V008",
            f"conv dispatch #{i} goes to {name} — an int8 plan runs a float "
            "kernel (fp32 operands) instead of its int8 variant",
        )
        for i, (_, name, _) in enumerate(convs)
        if not name.endswith("_int8")
    ]


# ---------------------------------------------------------------------------
# resource scope (V2xx)


def _group(gi, g) -> str:
    return f"fusion group {gi} (layers {tuple(g.layers)})"


def _recorded_smem(plan) -> list:
    """The shared memory a card plan records for each fusion group, in
    execution order (0 where it records none)."""
    n = len(plan.fusion_groups)
    smem = list(getattr(plan, "card_smem", ()))[:n]
    return smem + [0] * (n - len(smem))


@invariant("V201", name="group-budget", scope="resource")
def _group_budget(ctx):
    """Every fusion group's costed working set fits the plan's VMEM
    budget (skipped for budget-0 per-layer lowerings, whose single-layer
    groups are emitted unconditionally). On a card plan, every group's
    recorded shared memory per block (``CompiledDHM.card_smem``: the pyramid
    kernel's ``conv.pyramid_smem_bytes`` for a multi-layer group, the
    single-layer launcher's ``conv.fused_plan`` bytes for a singleton)
    stays within ``conv.SMEM_LIMIT``, at any budget, and a multi-layer
    group has at most ``conv.MAX_PYRAMID_LAYERS`` layers."""
    plan = ctx.plan
    out = []
    if plan.vmem_budget > 0:
        for gi, g in enumerate(plan.fusion_groups):
            if g.working_set > plan.vmem_budget:
                out.append(ctx.error(
                    "V201",
                    f"{_group(gi, g)} working set {g.working_set} B exceeds the "
                    f"vmem budget {plan.vmem_budget} B",
                ))
    if not ctx.on_card:
        return out
    for gi, (g, smem) in enumerate(zip(plan.fusion_groups, _recorded_smem(plan))):
        if smem > SMEM_LIMIT:
            out.append(ctx.error(
                "V201",
                f"{_group(gi, g)} requests {smem} B of shared memory per block, "
                f"above the {SMEM_LIMIT} B a Hopper block may use",
            ))
        if len(g.layers) > MAX_PYRAMID_LAYERS:
            out.append(ctx.error(
                "V201",
                f"{_group(gi, g)} has {len(g.layers)} layers; the pyramid kernel "
                f"takes at most {MAX_PYRAMID_LAYERS}",
            ))
    return out


@invariant("V202", name="cost-model-consistent", scope="resource")
def _cost_model_consistent(ctx):
    """Each multi-layer group's recorded working set equals what
    ``fusion.py`` / ``halo.py`` cost today for the same layers and
    block_rows — a stale or hand-edited plan cannot smuggle in an
    outdated cost. On a card plan, each group's recorded shared memory
    equals what ``conv.py`` sizes for it today
    (``compiler.card_group_cost``). A singleton's working set is not
    re-costed: the planner emits it unconditionally and records 0, which
    the reference's check reports as a mismatch on every per-layer plan;
    on the card the Hopper part costs singletons too."""
    from repro_torch.core.dhm.fusion import (
        group_working_set,
        group_working_set_breakdown,
        plan_elem_bytes,
    )

    plan = ctx.plan
    elem_bytes = plan_elem_bytes(plan.quant)
    out = []
    for gi, g in enumerate(plan.fusion_groups):
        if len(g.layers) < 2:
            continue
        try:
            want = group_working_set(
                plan.topo, g.layers, block_rows=g.block_rows,
                elem_bytes=elem_bytes,
            )
        except Exception as e:  # noqa: BLE001 — surfaced as a finding
            out.append(ctx.error(
                "V202", f"{_group(gi, g)} cannot be re-costed: {e}",
            ))
            continue
        if want != g.working_set:
            parts = group_working_set_breakdown(
                plan.topo, g.layers, block_rows=g.block_rows,
                elem_bytes=elem_bytes,
            )
            top = max(parts, key=parts.get)
            out.append(ctx.error(
                "V202",
                f"{_group(gi, g)} records a working set of {g.working_set} B but "
                f"the cost model says {want} B at {elem_bytes} B/elt (largest "
                f"component: {top} = {parts[top]} B)",
            ))
    if not ctx.on_card:
        return out
    for gi, (g, smem) in enumerate(zip(plan.fusion_groups, _recorded_smem(plan))):
        try:
            _, want, parts = card_cost(plan, g)
        except Exception as e:  # noqa: BLE001 — surfaced as a finding
            out.append(ctx.error(
                "V202", f"{_group(gi, g)} cannot be sized for the card: {e}",
            ))
            continue
        if want != smem:
            top = max(parts, key=parts.get)
            out.append(ctx.error(
                "V202",
                f"{_group(gi, g)} records {smem} B of shared memory per block "
                f"but conv.py sizes {want} B at {elem_bytes} B/elt (largest "
                f"component: {top} = {parts[top]} B)",
            ))
    return out


@invariant("V203", name="traced-working-set", scope="resource")
def _traced_working_set(ctx):
    """The reference reads each ``pallas_call``'s operand avals on its
    interpret backend and bounds them by the group's costed working set.
    On a card plan the port reads the dynamic shared memory each launch
    of the features really requested, which the launchers log beside
    the launch (``kernels/probe.py``): every launch must request some,
    no more than its group's recorded card bytes and no more than
    ``conv.SMEM_LIMIT`` — a planner under-estimate surfaces here, not
    as a refused launch. A CPU plan launches nothing, so V203 finds
    nothing there, as the reference's finds nothing on a non-interpret
    backend."""
    plan = ctx.plan
    if not ctx.on_card:
        return []
    groups = plan.fusion_groups
    try:
        counts = [card_cost(plan, g)[0] for g in groups]
    except Exception:  # noqa: BLE001 — V202 reports a group it cannot size
        return []
    launches = ctx.trace().phase_launches("features")
    if len(launches) != sum(counts):
        return []  # V002 reports the mismatch
    out, i = [], 0
    for gi, (g, n, costed) in enumerate(zip(groups, counts, _recorded_smem(plan))):
        for _, name, smem in launches[i:i + n]:
            if smem <= 0:
                out.append(ctx.error(
                    "V203",
                    f"{_group(gi, g)}: a {name} launch logged no dynamic shared "
                    "memory — its launcher did not report the bytes it requested",
                ))
            elif smem > costed or smem > SMEM_LIMIT:
                out.append(ctx.error(
                    "V203",
                    f"{_group(gi, g)}: a {name} launch requested {smem} B of shared "
                    f"memory, above the group's costed {costed} B or the {SMEM_LIMIT} B "
                    "limit — the planner under-estimated",
                ))
        i += n
    return out


@invariant("V204", name="int8-slab-costing", scope="resource")
def _int8_slab_costing(ctx):
    """An int8 plan charges int8 slab bytes (1 B/elt for the resident
    frame, feature slabs and weight codes; int32 accumulators stay 4 B)
    against ``vmem_budget`` — the recorded working sets of multi-layer
    groups must equal the int8 costing and be strictly below what the
    same group costs at fp32. A plan that books fp32 bytes under an int8
    contract wastes the budget headroom the 1-byte slabs buy. On a card
    plan the same holds for the shared memory: every group's recorded
    bytes equal its int8 layout (``conv.int8_pyramid_layout``, or
    ``conv.fused_plan`` at 1 B/elt for a singleton), and a multi-layer
    group's are strictly below the same group's fp32 pyramid. Singletons
    are not re-costed against the working set (see V202)."""
    from repro_torch.core.dhm.fusion import group_working_set, plan_elem_bytes

    plan = ctx.plan
    if plan_elem_bytes(plan.quant) != 1:
        return []
    out = []
    for gi, g in enumerate(plan.fusion_groups):
        if len(g.layers) < 2:
            continue
        try:
            want_int8 = group_working_set(
                plan.topo, g.layers, block_rows=g.block_rows, elem_bytes=1
            )
            want_fp32 = group_working_set(
                plan.topo, g.layers, block_rows=g.block_rows, elem_bytes=4
            )
        except Exception as e:  # noqa: BLE001 — surfaced as a finding
            out.append(ctx.error(
                "V204", f"{_group(gi, g)} cannot be re-costed: {e}",
            ))
            continue
        if g.working_set != want_int8:
            out.append(ctx.error(
                "V204",
                f"{_group(gi, g)} records {g.working_set} B under an int8 plan; "
                f"the int8 costing says {want_int8} B",
            ))
        elif g.working_set >= want_fp32:
            out.append(ctx.error(
                "V204",
                f"{_group(gi, g)} int8 working set {g.working_set} B is not below "
                f"the fp32 costing {want_fp32} B — int8 slabs bought no headroom",
            ))
    if not ctx.on_card:
        return out
    for gi, (g, smem) in enumerate(zip(plan.fusion_groups, _recorded_smem(plan))):
        try:
            want_int8 = card_cost(plan, g, 1)[1]
            want_fp32 = card_cost(plan, g, 4)[1] if len(g.layers) > 1 else None
        except Exception as e:  # noqa: BLE001 — surfaced as a finding
            out.append(ctx.error(
                "V204", f"{_group(gi, g)} cannot be sized for the card: {e}",
            ))
            continue
        if smem != want_int8:
            out.append(ctx.error(
                "V204",
                f"{_group(gi, g)} records {smem} B of shared memory under an int8 "
                f"plan; its int8 layout takes {want_int8} B",
            ))
        elif want_fp32 is not None and smem >= want_fp32:
            out.append(ctx.error(
                "V204",
                f"{_group(gi, g)} int8 block of {smem} B is not below the fp32 "
                f"pyramid's {want_fp32} B — int8 slabs bought no shared memory",
            ))
    return out


# ---------------------------------------------------------------------------
# pipeline scope (V1xx)


def _transfers_by_class(ctx):
    """Group the probe's logged transfers by the class they were sent in,
    and match each group to an EdgePlan shape class by its (src, dst)
    pairs, as the reference matches each ``ppermute`` by its perm;
    returns (assignments [(class, transfers)], unmatched groups)."""
    probe = ctx.pipeline
    groups: dict = {}
    for c, pair, shape in probe.transfers:
        groups.setdefault(c, []).append((c, tuple(pair), tuple(shape)))
    pairs_of = {
        c: frozenset(map(tuple, probe.edge_plan.class_pairs(c)))
        for c in range(probe.edge_plan.n_classes)
    }
    assigned, unmatched = [], []
    for group in groups.values():
        pairs = frozenset(pair for _, pair, _ in group)
        for c, want in pairs_of.items():
            if pairs == want:
                assigned.append((c, group))
                break
        else:
            unmatched.append(group)
    return assigned, unmatched


@invariant("V101", name="interior-edge-count", scope="pipeline")
def _interior_edge_count(ctx):
    """The pipelined run makes exactly the EdgePlan's transfers: one group
    per shape class, whose (src, dst) pairs together cover every interior
    edge (s, s+1) exactly once — S-1 edges total."""
    probe = ctx.pipeline
    if probe is None:
        return []
    ep = probe.edge_plan
    if ep.n_edges == 0:
        return []
    assigned, unmatched = _transfers_by_class(ctx)
    out = []
    if unmatched:
        pairs = [sorted({pair for _, pair, _ in g}) for g in unmatched]
        out.append(ctx.error(
            "V101",
            f"{len(unmatched)} logged transfer class(es) match no EdgePlan "
            f"shape class: pairs {pairs}",
        ))
    got_classes = sorted(c for c, _ in assigned)
    want_classes = list(range(ep.n_classes))
    if got_classes != want_classes:
        out.append(ctx.error(
            "V101",
            f"the run's transfers cover shape classes {got_classes}; the "
            f"EdgePlan requires exactly one transfer group per class "
            f"{want_classes}",
        ))
        return out
    covered = set()
    for c, _ in assigned:
        covered.update(map(tuple, ep.class_pairs(c)))
    want = {(s, s + 1) for s in range(ep.n_edges)}
    if covered != want:
        out.append(ctx.error(
            "V101",
            f"the run's transfers cover interior edges {sorted(covered)}; the "
            f"plan has {ep.n_edges} interior edges {sorted(want)}",
        ))
    return out


@invariant("V102", name="edge-exact-shape", scope="pipeline")
def _edge_exact_shape(ctx):
    """Each class's transfers move exactly (microbatch, *class_shape)
    elements — no silently widened (padded) transfer on the exact path."""
    probe = ctx.pipeline
    if probe is None or probe.edge_plan.n_edges == 0:
        return []
    assigned, _ = _transfers_by_class(ctx)
    out = []
    for c, group in assigned:
        want = (probe.mb_local,) + tuple(probe.edge_plan.class_shapes[c])
        got = sorted({shape for _, _, shape in group})
        if got != [want]:
            out.append(ctx.error(
                "V102",
                f"shape class {c} transfers move {got}; the EdgePlan "
                f"promises exactly {want}",
            ))
    return out


@invariant("V103", name="boxed-padding", scope="pipeline")
def _boxed_padding(ctx):
    """A boxed (max-shape) edge fallback is legal but pays padding bytes
    on every hop — flag it with the fraction so the regression is
    visible, not silent."""
    probe = ctx.pipeline
    if probe is None or probe.edge_plan.mode != "boxed":
        return []
    frac = probe.edge_plan.padding_fraction()
    return [ctx.warning(
        "V103",
        f"edge plan fell back to boxed transfers: "
        f"{frac:.1%} of every interior-edge hop is padding",
    )]
