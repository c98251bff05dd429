"""The port's plan verifier on the CPU, held against the reference's
(``tests/test_analysis.py``).

- the registry: the port's IDs, names and scopes are the reference's,
  for every invariant, and ``by_scope`` gives the same IDs per scope;
- seeded plan defects that have a counterpart in the port (non-finite
  params, a broken IO chain, dtype drift, a host round-trip, float
  kernels under an int8 contract, a stage that splits its fusion group)
  give the same invariant IDs as the reference's ``verify_plan`` on the
  same defect;
- clean plans of all five topologies verify clean, fp32, fake-quant and
  int8;
- a probe counts only its own thread's dispatches, however many another
  thread makes meanwhile;
- the pipeline scope (V101-V103): clean on good plans of all five
  topologies; the reference test's three seeded defects (a dropped edge
  class, a widened transfer, the boxed fallback) are found under the same
  IDs; the probe reads only its own thread's transfers. The reference's
  own pipeline-scope tests need two devices and skip in a plain run; the
  port's probe runs on a CPU mesh;
- the resource scope (V201-V204): the reference test's seeded defects
  (an inflated working set, fp32 bytes under an int8 contract) give the
  same IDs in both packages; a per-layer plan's singletons, which the
  reference's V202 reports, are not re-costed; the Hopper parts pass on
  the card groups of all five topologies (built by
  ``card_fusion_groups`` on the CPU, in a plan marked for the card that
  nothing runs) and find inflated, stale and fp32-costed card bytes, and
  V203 holds a hand-made launch log against the costed bytes;
- asking for an unknown scope or an ID the port does not have raises.
"""
import pytest

torch = pytest.importorskip("torch")

# One intra-op thread: the suite runs in parallel workers, and idle
# OpenMP threads would spin on cores that timing tests elsewhere use.
torch.set_num_threads(1)

import dataclasses  # noqa: E402
import functools  # noqa: E402
import threading  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.analysis import invariants as jinvariants  # noqa: E402
from repro.analysis.verify import verify_plan as jverify_plan  # noqa: E402
from repro.core.dhm import compiler as jcompiler  # noqa: E402
from repro.core.dhm.pipeline import StageIOSpec as JStageIOSpec  # noqa: E402
from repro.models.cnn import ALL_TOPOLOGIES as JAX_TOPOLOGIES  # noqa: E402
from repro.models.cnn import init_cnn as jax_init_cnn  # noqa: E402
from repro_torch.analysis import invariants as tinvariants  # noqa: E402
from repro_torch.analysis.findings import Finding  # noqa: E402
from repro_torch.analysis.verify import (  # noqa: E402
    PipelineProbe,
    ProbeContext,
    make_pipeline_probe,
    verify_plan,
)
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.dhm import Engine, PlanCheckError, QuantSpec, compile_dhm, emit_conv_stage  # noqa: E402
from repro_torch.core.dhm.pipeline import StageIOSpec  # noqa: E402
from repro_torch.kernels.stream_conv import stream_conv_block  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.models.cnn import ALL_TOPOLOGIES  # noqa: E402

NAME = "lenet5"


def _ids(findings):
    return sorted({f.rule for f in findings})


@functools.lru_cache(maxsize=None)
def _np_params(name="lenet5", seed=0):
    params = jax_init_cnn(jax.random.PRNGKey(seed), JAX_TOPOLOGIES[name])
    return jax.tree_util.tree_map(np.asarray, params)


def _plans(name=NAME, *, jax_backend=None, **kw):
    """(reference plan, port CPU plan) of ``name`` on the same params."""
    quant = kw.pop("quant", {})
    p = _np_params(name)
    jplan = jcompiler.compile_dhm(JAX_TOPOLOGIES[name], jax.tree_util.tree_map(jnp.asarray, p),
                                  quant=jcompiler.QuantSpec(**quant), backend=jax_backend, **kw)
    tplan = compile_dhm(ALL_TOPOLOGIES[name], params_from_numpy(p, "cpu"),
                        quant=QuantSpec(**quant), device="cpu", **kw)
    return jplan, tplan


def _tparams(name):
    """The port's own init of ``name`` (seed 0), for the checks that
    compare with no reference plan."""
    return tcnn.init_cnn(torch.Generator().manual_seed(0), ALL_TOPOLOGIES[name], device="cpu")


def _tplan(name=NAME, **kw):
    """The port's CPU plan of ``name`` alone."""
    quant = kw.pop("quant", {})
    return compile_dhm(ALL_TOPOLOGIES[name], _tparams(name), quant=QuantSpec(**quant),
                       device="cpu", **kw)


# ---------------------------------------------------------------------------
# registry hygiene


class TestRegistry:
    def test_ids_names_and_scopes_are_the_references(self):
        want = {i: (inv.name, inv.scope) for i, inv in jinvariants.REGISTRY.items()}
        got = {i: (inv.name, inv.scope) for i, inv in tinvariants.REGISTRY.items()}
        assert got == want
        assert tinvariants.SCOPES == jinvariants.SCOPES
        assert {inv.id for inv in tinvariants.REGISTRY.values() if inv.scope == "pipeline"} == \
            {"V101", "V102", "V103"}
        assert {inv.id for inv in tinvariants.REGISTRY.values() if inv.scope == "resource"} == \
            {"V201", "V202", "V203", "V204"}

    @pytest.mark.parametrize("scopes", [(s,) for s in jinvariants.SCOPES]
                             + [("plan", "resource"), tuple(jinvariants.SCOPES)])
    def test_by_scope_gives_the_references_ids(self, scopes):
        assert [inv.id for inv in tinvariants.by_scope(*scopes)] == [
            inv.id for inv in jinvariants.by_scope(*scopes)]

    def test_every_invariant_says_what_it_checks(self):
        for inv in tinvariants.REGISTRY.values():
            assert inv.doc.strip(), f"{inv.id} has no doc"
        assert "nothing" in tinvariants.REGISTRY["V001"].doc  # no counterpart in PyTorch
        # V006 reads the port's donation: the graph's handed-over input buffer.
        assert "input_buffer" in tinvariants.REGISTRY["V006"].doc
        assert "CUDA graph" in tinvariants.REGISTRY["V005"].doc

    def test_finding_severity_validated(self):
        with pytest.raises(ValueError):
            Finding(rule="X", name="x", severity="fatal", message="m")


class TestUnportedScopes:
    def test_unported_scope_or_id_raises(self):
        """Every scope is ported: asking for the resource scope, the last
        one ported, verifies; an ID or a scope the registry does not have
        still raises."""
        plan = _tplan()
        for scopes in (("resource",), ("plan", "resource")):
            assert verify_plan(plan, scopes=scopes) == []
        assert verify_plan(plan, ids=("V201",)) == []
        with pytest.raises(NotImplementedError, match="no invariant V299"):
            verify_plan(plan, ids=("V299",))
        with pytest.raises(ValueError, match="unknown scopes"):
            verify_plan(plan, scopes=("nope",))


# ---------------------------------------------------------------------------
# clean runs


class TestCleanRun:
    @pytest.mark.parametrize("name", sorted(ALL_TOPOLOGIES))
    def test_topology_verifies_clean(self, name):
        p = _tparams(name)
        n_conv = len(ALL_TOPOLOGIES[name].conv_layers)
        for quant in (QuantSpec(), QuantSpec(weight_bits=6, act_bits=6),
                      QuantSpec(weight_bits=8, act_bits=8, int8_compute=True),
                      QuantSpec(act_bits=8, pow2_weights=True, int8_compute=True,
                                per_layer_bits=(8,) * n_conv)):
            for budget in (None, 0):
                plan = compile_dhm(ALL_TOPOLOGIES[name], p, quant=quant, vmem_budget=budget,
                                   device="cpu")
                assert verify_plan(plan) == [], f"{name}/{quant}/{budget}"

    def test_probe_reads_one_dispatch_per_group_and_float32_boundaries(self):
        plan = _tplan(quant=dict(weight_bits=8, act_bits=8, int8_compute=True),
                         vmem_budget=0)
        tr = ProbeContext(plan).trace()
        assert [d[1:] for d in tr.phase_dispatches("features")] == [
            ("stream_conv_fused_int8", True)] * len(plan.fusion_groups)
        assert tr.launches == []  # a CPU plan launches nothing
        assert tr.stage_dtypes == [torch.float32] and tr.logits_dtype == torch.float32
        assert not any(op.to_host for op in tr.ops)

    def test_kernel_only_checks_find_nothing_on_a_cpu_plan(self):
        plan = _tplan(quant=dict(weight_bits=6, act_bits=6))
        assert verify_plan(plan, ids=("V001", "V003", "V006", "V007")) == []

    def test_planned_launches_count_the_strips(self):
        """A singleton too wide for one block of the single-layer kernel
        runs in column strips, one launch each: V002's count on the card."""
        spec = tcnn.ConvLayerSpec(n_out=8, kernel=5, padding="SAME", pool=2, act="relu")
        wide = tcnn.CNNTopology("wide", (12, 4100), 3, (spec,), (), 10)
        plan = compile_dhm(wide, tcnn.init_cnn(torch.Generator().manual_seed(0), wide,
                                               device="cpu"), device="cpu")
        assert len(plan.fusion_groups) == 1
        assert tinvariants.planned_launches(plan) > 1
        lenet = _tplan()
        assert tinvariants.planned_launches(lenet) == 1  # one pyramid group


# ---------------------------------------------------------------------------
# seeded plan defects -> the reference's invariant IDs


def _both_ids(jbad, tbad, **kw):
    want = _ids(f for f in jverify_plan(jbad, **kw) if f.is_error)
    got = _ids(f for f in verify_plan(tbad, **kw) if f.is_error)
    assert got == want
    return got


class TestSeededPlanDefects:
    def test_nonfinite_param_is_V301(self):
        jplan, tplan = _plans()
        jbad = dataclasses.replace(jplan, conv_params=tuple(
            {k: (v.at[0].set(jnp.nan) if k == "b" else v) for k, v in p.items()} if i == 0 else p
            for i, p in enumerate(jplan.conv_params)))
        tb = tplan.conv_params[0]["b"].clone()
        tb[0] = float("nan")
        tbad = dataclasses.replace(tplan, conv_params=(
            {"w": tplan.conv_params[0]["w"], "b": tb},) + tplan.conv_params[1:])
        assert _both_ids(jbad, tbad, scopes=("plan",)) == ["V301"]
        with pytest.raises(PlanCheckError) as ei:
            tbad.self_check()
        assert ei.value.invariants == ("V301",)

    def test_broken_io_chain_is_V302(self):
        jplan, tplan = _plans(n_stages=2)
        bad = []
        for plan, io_cls in ((jplan, JStageIOSpec), (tplan, StageIOSpec)):
            st0 = plan.stages[0]
            io = io_cls(in_shape=st0.io.in_shape, out_shape=(1, 1, 999))
            bad.append(dataclasses.replace(
                plan, stages=(dataclasses.replace(st0, io=io),) + plan.stages[1:]))
        ids = _both_ids(*bad, scopes=("plan",))
        assert "V302" in ids and "V303" in ids

    def test_fp32_compute_under_int8_contract_is_V008(self):
        jfq, tfq = _plans(quant=dict(weight_bits=8, act_bits=8))
        jlying = dataclasses.replace(
            jfq, quant=jcompiler.QuantSpec(weight_bits=8, act_bits=8, int8_compute=True))
        tlying = dataclasses.replace(
            tfq, quant=QuantSpec(weight_bits=8, act_bits=8, int8_compute=True))
        assert _both_ids(jlying, tlying, ids=("V008",)) == ["V008"]
        assert any("float" in f.message for f in verify_plan(tlying, ids=("V008",)))

    def test_dtype_drift_is_V004(self):
        jplan, tplan = _plans()
        jbad = dataclasses.replace(jplan, head_fn=lambda h, _i=jplan.head_fn: _i(
            h.astype(jnp.bfloat16).astype(jnp.float32)))
        tbad = dataclasses.replace(tplan, head_fn=lambda h, _i=tplan.head_fn: _i(
            h.to(torch.bfloat16).to(torch.float32)))
        assert _both_ids(jbad, tbad, ids=("V004",)) == ["V004"]

    def test_host_round_trip_is_V005(self):
        """A stage body that reads a value to the host: a callback in the
        reference's trace, a ``.item()`` in the port's probe."""
        jplan, tplan = _plans()
        jst, tst = jplan.stages[0], tplan.stages[0]

        def jfn(params, x, _f=jst.fn):
            x = jax.pure_callback(lambda a: a, jax.ShapeDtypeStruct(x.shape, x.dtype), x)
            return _f(params, x)

        def tfn(params, x, _f=tst.fn):
            float(x.sum())
            return _f(params, x)

        jbad = dataclasses.replace(jplan, stages=(dataclasses.replace(jst, fn=jfn),))
        tbad = dataclasses.replace(tplan, stages=(dataclasses.replace(tst, fn=tfn),))
        assert _both_ids(jbad, tbad, ids=("V005",)) == ["V005"]

    def test_dropped_donation_is_V006(self):
        """The reference's ``_DropsDonate``: a plan whose
        ``jitted_forward(donate=True)`` returns the non-donating closure.
        The reference's lowering carries no donation marker; the port's
        closure declares no donation."""
        jplan, tplan = _plans()

        class _DropsDonate:
            """A plan whose jitted_forward silently ignores donate=."""

            def __init__(self, plan):
                self._plan = plan
                self.topo = plan.topo
                self.backend = getattr(plan, "backend", None)
                self.device = getattr(plan, "device", None)

            def jitted_forward(self, *, donate=False):
                return self._plan.jitted_forward(donate=False)

        assert _ids(jverify_plan(_DropsDonate(jplan), ids=("V006",))) == ["V006"]
        found = verify_plan(_DropsDonate(tplan), ids=("V006",))
        assert _ids(found) == ["V006"] and "dropped" in found[0].message

    def test_good_plan_declares_donation(self):
        jplan, tplan = _plans()
        assert jverify_plan(jplan, ids=("V006",)) == []
        assert verify_plan(tplan, ids=("V006",)) == []
        rep = ProbeContext(tplan).lower_donated()
        assert rep.declared and rep.input_copies is None  # a CPU plan's closure is eager

    def test_a_cpu_plan_captures_nothing(self):
        ctx = ProbeContext(_tplan())
        assert ctx.capture_error() is None
        assert ctx.plan.jitted_forward()._cache_size() == 0
        assert ProbeContext(object()).lower_donated() is None  # no jitted_forward surface

    def test_stage_that_splits_its_group_is_V002(self):
        """The plan says one fusion group; the stage body runs its layers
        as separate kernel calls. The reference counts pallas_calls on its
        interpret backend; the port counts kernel dispatches."""
        jplan, tplan = _plans(jax_backend="pallas_interpret")
        assert len(tplan.fusion_groups) == len(jplan.fusion_groups) == 1
        jst, tst = jplan.stages[0], tplan.stages[0]
        jsplit = dataclasses.replace(jplan, stages=(dataclasses.replace(
            jst, fn=jcompiler.emit_conv_stage(jst.specs, backend="pallas_interpret")),))
        tsplit = dataclasses.replace(tplan, stages=(dataclasses.replace(
            tst, fn=emit_conv_stage(tst.specs)),))
        assert _both_ids(jsplit, tsplit, ids=("V002",)) == ["V002"]
        # One kernel call per layer is right where the plan groups each
        # layer alone. (The reference's interpret pyramid does not trace
        # under this JAX, so the clean fused plan is held on the port only.)
        assert _both_ids(*_plans(jax_backend="pallas_interpret", vmem_budget=0),
                         ids=("V002",)) == []
        assert verify_plan(tplan, ids=("V002",)) == []


# ---------------------------------------------------------------------------
# the probe counts its own thread only


def test_probe_is_not_disturbed_by_another_threads_dispatches():
    """While another thread serves the same plan through an Engine and
    calls the conv wrappers in a loop, the probe still reads exactly its
    own one dispatch per fusion group."""
    plan = _tplan(vmem_budget=0)
    stop = threading.Event()
    busy = []
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 28, 28, 1)).astype(np.float32))
    w, b = plan.conv_params[0]["w"], plan.conv_params[0]["b"]
    eng = Engine(plan, microbatch=2)

    def hammer():
        while not stop.is_set():
            stream_conv_block(x, w, b, padding="VALID", act="relu", pool=2)
            eng.infer(x.numpy())
            busy.append(1)

    t = threading.Thread(target=hammer, daemon=True)
    t.start()
    try:
        while not busy:
            stop.wait(0.001)
        for _ in range(5):
            ctx = ProbeContext(plan)
            assert len(ctx.trace().phase_dispatches("features")) == len(plan.fusion_groups)
            assert verify_plan(plan) == []
    finally:
        stop.set()
        t.join(timeout=30.0)
    assert not t.is_alive() and len(busy) > 1


# ---------------------------------------------------------------------------
# the serving path cites the same registry


def test_demotion_record_cites_invariants():
    e = PlanCheckError("nope", invariants=("V301", "V303"))
    rec = Engine._demotion_record("fused", e)
    assert rec["invariants"] == ["V301", "V303"] and rec["rung"] == "fused"
    assert "invariants" not in Engine._demotion_record("fused", RuntimeError("x"))


# ---------------------------------------------------------------------------
# the pipeline scope (V1xx)


class TestPipelineScope:
    @pytest.mark.parametrize("name", sorted(ALL_TOPOLOGIES))
    def test_pipeline_scope_is_clean_on_good_plans(self, name):
        p = _tparams(name)
        n_conv = len(ALL_TOPOLOGIES[name].conv_layers)
        for quant in (QuantSpec(), QuantSpec(weight_bits=8, act_bits=8, int8_compute=True)):
            for n_stages in range(1, n_conv + 1):
                plan = compile_dhm(ALL_TOPOLOGIES[name], p, quant=quant, n_stages=n_stages,
                                   device="cpu")
                for overlap in (False, True):
                    pr = make_pipeline_probe(plan, overlap=overlap)
                    assert verify_plan(plan, scopes=("pipeline",), pipeline=pr) == []
                    assert len(pr.transfers) == (n_stages - 1) * pr.cfg.n_microbatches
                assert verify_plan(plan, pipeline=make_pipeline_probe(plan)) == []

    def test_without_a_probe_the_scope_finds_nothing(self):
        assert verify_plan(_tplan(n_stages=2), scopes=("pipeline",)) == []

    def test_dropped_edge_class_is_V101(self):
        plan = _tplan(n_stages=2)
        probe_ = make_pipeline_probe(plan, microbatch=2)
        ep = probe_.edge_plan
        # claim a second shape class that no logged transfer serves
        tampered = dataclasses.replace(
            ep, class_shapes=ep.class_shapes + ((9, 9, 9),),
            edge_class=tuple(1 for _ in ep.edge_class))
        bad = dataclasses.replace(probe_, edge_plan=tampered)
        assert "V101" in _ids(verify_plan(plan, scopes=("pipeline",), pipeline=bad))

    def test_transfers_over_an_unplanned_edge_are_V101(self):
        plan = _tplan("cifar10", n_stages=3)
        probe_ = make_pipeline_probe(plan)
        bad = dataclasses.replace(probe_, transfers=[
            (c, (0, 2) if pair == (0, 1) else pair, shape) for c, pair, shape in probe_.transfers])
        assert _ids(verify_plan(plan, scopes=("pipeline",), pipeline=bad)) == ["V101"]
        dropped = dataclasses.replace(probe_, transfers=[
            t for t in probe_.transfers if t[1] != (1, 2)])
        assert "V101" in _ids(verify_plan(plan, scopes=("pipeline",), pipeline=dropped))

    def test_wrong_edge_shape_is_V102(self):
        plan = _tplan(n_stages=2)
        probe_ = make_pipeline_probe(plan, microbatch=2)
        ep = probe_.edge_plan
        tampered = dataclasses.replace(ep, class_shapes=((9, 9, 9),) * len(ep.class_shapes))
        bad = dataclasses.replace(probe_, edge_plan=tampered)
        assert "V102" in _ids(verify_plan(plan, scopes=("pipeline",), pipeline=bad))
        widened = dataclasses.replace(probe_, transfers=[
            (c, pair, (shape[0],) + tuple(d + 1 for d in shape[1:]))
            for c, pair, shape in probe_.transfers])
        assert _ids(verify_plan(plan, scopes=("pipeline",), pipeline=widened)) == ["V102"]

    def test_boxed_fallback_is_flagged_V103(self):
        for name, n_stages in (("lenet5", 2), ("cifar10", 3)):
            plan = _tplan(name, n_stages=n_stages)
            probe_ = make_pipeline_probe(plan, microbatch=2, edge_mode="boxed")
            findings = verify_plan(plan, scopes=("pipeline",), pipeline=probe_)
            warnings_ = [f for f in findings if f.rule == "V103"]
            assert len(findings) == len(warnings_) == 1
            assert not warnings_[0].is_error and "padding" in warnings_[0].message
            assert warnings_[0].name == "boxed-padding"

    def test_probe_reads_only_its_own_threads_transfers(self):
        from repro_torch.launch.mesh import make_mesh

        plan = _tplan("cifar10", n_stages=3)
        other = compile_dhm(ALL_TOPOLOGIES["cifar10"], _tparams("cifar10"), n_stages=3,
                            device="cpu")
        mesh = make_mesh((3,), ("stage",), device="cpu")
        x = torch.zeros((2, 2, 32, 32, 3))
        stop, busy = threading.Event(), []

        def hammer():
            while not stop.is_set():
                other.run_pipelined(x, mesh=mesh, edge_mode="boxed")
                busy.append(1)

        t = threading.Thread(target=hammer, daemon=True)
        t.start()
        try:
            while not busy:
                stop.wait(0.001)
            for _ in range(3):
                pr = make_pipeline_probe(plan, n_microbatches=4)
                assert isinstance(pr, PipelineProbe)
                assert len(pr.transfers) == 2 * 4 and pr.mb_local == 2
                assert verify_plan(plan, scopes=("pipeline",), pipeline=pr) == []
        finally:
            stop.set()
            t.join(timeout=30.0)
        assert not t.is_alive() and len(busy) > 1


# ---------------------------------------------------------------------------
# the resource scope (V2xx)


def _replace_group(plan, gi, **changes):
    """A copy of ``plan`` with fusion group ``gi`` mutated (the reference
    test's helper)."""
    flat = list(plan.fusion_groups)
    flat[gi] = dataclasses.replace(flat[gi], **changes)
    stages, k = [], 0
    for st in plan.stages:
        n = len(st.groups)
        stages.append(dataclasses.replace(st, groups=tuple(flat[k:k + n])))
        k += n
    return dataclasses.replace(plan, stages=tuple(stages))


def _card_plan(name=NAME, **kw):
    """The port's CPU plan of ``name`` with the groups a plan for the card
    runs (``card_fusion_groups``) and the bytes ``compile_dhm`` records for
    them on the card (``card_group_cost``), marked for the card. Nothing
    runs it: only the host-side checks (V201, V202, V204) read it, and
    V203 a hand-made launch log."""
    from repro_torch.core.dhm.compiler import card_fusion_groups, card_group_cost
    from repro_torch.core.dhm.fusion import plan_elem_bytes

    plan = _tplan(name, **kw)
    eb = plan_elem_bytes(plan.quant)
    stages = []
    for st in plan.stages:
        groups = card_fusion_groups(plan.topo, st.conv_layers, st.groups, elem_bytes=eb,
                                    block_r=plan.block_r)
        stages.append(dataclasses.replace(st, groups=groups, card_smem=tuple(
            card_group_cost(plan.topo, g.layers, g.block_rows, elem_bytes=eb,
                            block_r=plan.block_r)[1] for g in groups)))
    return dataclasses.replace(plan, stages=tuple(stages), device=torch.device("cuda"))


def _replace_smem(plan, gi, smem):
    """A copy of a card plan with fusion group ``gi``'s recorded bytes
    replaced."""
    flat = list(plan.card_smem)
    flat[gi] = smem
    stages, k = [], 0
    for st in plan.stages:
        n = len(st.groups)
        stages.append(dataclasses.replace(st, card_smem=tuple(flat[k:k + n])))
        k += n
    return dataclasses.replace(plan, stages=tuple(stages))


_HOST_IDS = ("V201", "V202", "V204")
_INT8 = dict(weight_bits=8, act_bits=8, int8_compute=True)


def _launch_log(plan, smem_of=lambda g, smem: smem):
    """A structure trace whose features launched what ``plan`` plans, each
    launch requesting ``smem_of(group, costed bytes)``."""
    from repro_torch.analysis.verify import StructureTrace

    launches = []
    for g in plan.fusion_groups:
        n, smem, _ = tinvariants.card_cost(plan, g)
        name = "stream_conv_pyramid" if len(g.layers) > 1 else "stream_conv_fused"
        launches += [("features", name, smem_of(g, smem))] * n
    return StructureTrace(stage_dtypes=[], logits_dtype=torch.float32, ops=[],
                          dispatches=[], launches=launches)


def _v203(plan, trace):
    ctx = ProbeContext(plan)
    ctx._trace = trace
    return tinvariants.REGISTRY["V203"].fn(ctx)


class TestResourceScope:
    def test_inflated_working_set_is_V201_V202(self):
        jplan, tplan = _plans()
        jbad = _replace_group(jplan, 0, working_set=10**9)
        tbad = _replace_group(tplan, 0, working_set=10**9)
        assert _both_ids(jbad, tbad, scopes=("resource",)) == ["V201", "V202"]
        msgs = [f.message for f in verify_plan(tbad, scopes=("resource",)) if f.rule == "V202"]
        assert any("largest component" in m for m in msgs)

    def test_fp32_bytes_under_int8_contract_is_V204(self):
        from repro_torch.core.dhm.fusion import group_working_set

        jplan, tplan = _plans(quant=_INT8)
        g = tplan.fusion_groups[0]
        fp32 = group_working_set(tplan.topo, g.layers, block_rows=g.block_rows, elem_bytes=4)
        jbad, tbad = (_replace_group(p, 0, working_set=fp32) for p in (jplan, tplan))
        assert _both_ids(jbad, tbad, ids=("V204",)) == ["V204"]
        assert _both_ids(jplan, tplan, ids=("V204",)) == []

    @pytest.mark.parametrize("quant", [{}, _INT8], ids=["fp32", "int8"])
    def test_clean_plans_and_the_traced_check_agree_with_the_reference(self, quant):
        """Both packages find nothing on a good plan; V203 finds nothing on
        a plan that launches no kernel (the reference's off its interpret
        backend, the port's on the CPU), even with an understated cost."""
        jplan, tplan = _plans(quant=quant)
        assert _both_ids(jplan, tplan, scopes=("resource",)) == []
        jbad, tbad = (_replace_group(p, 0, working_set=1) for p in (jplan, tplan))
        assert _both_ids(jbad, tbad, ids=("V203",)) == []
        assert "V202" in _both_ids(jbad, tbad, scopes=("resource",))

    def test_per_layer_singletons_are_not_re_costed(self):
        """The reference's V202 (and V204 on an int8 plan) re-costs the
        singletons of a per-layer plan, which its planner records at 0 B,
        and reports each; the port re-costs only fused groups."""
        for quant, rule in (({}, "V202"), (_INT8, "V204")):
            jplan, tplan = _plans(quant=quant, vmem_budget=0)
            assert rule in _ids(jverify_plan(jplan, scopes=("resource",)))
            assert verify_plan(tplan, scopes=("resource",)) == []

    @pytest.mark.parametrize("name", sorted(ALL_TOPOLOGIES))
    def test_card_groups_pass_the_hopper_parts(self, name):
        for quant in ({}, dict(weight_bits=6, act_bits=6), _INT8):
            for budget in (None, 0):
                plan = _card_plan(name, quant=quant, vmem_budget=budget)
                assert len(plan.card_smem) == len(plan.fusion_groups)
                assert all(0 < b <= 232_448 for b in plan.card_smem)
                assert verify_plan(plan, ids=_HOST_IDS) == [], f"{name}/{quant}/{budget}"
                assert _v203(plan, _launch_log(plan)) == []

    def test_card_bytes_past_the_block_limit_are_V201(self):
        plan = _card_plan("cifar10")
        bad = _replace_smem(plan, 0, 232_448 + 16)
        findings = verify_plan(bad, ids=_HOST_IDS)
        assert _ids(findings) == ["V201", "V202"]
        assert any("232448" in f.message for f in findings if f.rule == "V201")
        # the same group on a CPU plan has no card part to break
        assert verify_plan(dataclasses.replace(bad, device=torch.device("cpu")),
                           ids=_HOST_IDS) == []

    def test_stale_card_bytes_are_V202(self):
        plan = _card_plan("cifar10", vmem_budget=0)
        bad = _replace_smem(plan, 1, plan.card_smem[1] - 16)
        findings = verify_plan(bad, ids=_HOST_IDS)
        assert _ids(findings) == ["V202"]
        assert "largest component" in findings[0].message
        # a card plan that records no bytes at all; a CPU plan records none
        unrecorded = dataclasses.replace(plan, stages=tuple(
            dataclasses.replace(st, card_smem=()) for st in plan.stages))
        assert _ids(verify_plan(unrecorded, ids=_HOST_IDS)) == ["V202"]
        assert _tplan("cifar10").card_smem == ()

    def test_fp32_card_bytes_under_int8_contract_are_V204(self):
        plan = _card_plan("lenet5", quant=_INT8)
        fp32 = tinvariants.card_cost(plan, plan.fusion_groups[0], 4)[1]
        assert plan.card_smem[0] < fp32
        bad = _replace_smem(plan, 0, fp32)
        assert _ids(verify_plan(bad, ids=("V204",))) == ["V204"]

    def test_launch_log_over_the_costed_bytes_is_V203(self):
        for name, budget in (("lenet5", None), ("cifar10", 0)):
            plan = _card_plan(name, vmem_budget=budget)
            over = _v203(plan, _launch_log(plan, lambda g, smem: smem + 16))
            assert _ids(over) == ["V203"] and len(over) == len(plan.fusion_groups)
            assert "under-estimated" in over[0].message
            silent = _v203(plan, _launch_log(plan, lambda g, smem: 0))
            assert _ids(silent) == ["V203"] and "no dynamic shared memory" in silent[0].message
            # a launch log that does not match the plan is V002's finding
            short = _launch_log(plan, lambda g, smem: smem + 16)
            short.launches.pop()
            assert _v203(plan, short) == []
