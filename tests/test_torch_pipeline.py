"""The port's spatial pipeline on a CPU mesh, held against the reference.

- ``plan_edges`` / ``EdgePlan`` (classes, pairs, bytes, padding fraction,
  every mode) equal the reference's on all five topologies at every
  ``n_stages``, and on ``tests/test_throughput.py``'s synthetic chains;
- for all five topologies, every ``n_stages`` from 1 to L, fp32, 6-bit
  fake-quant and int8: the pipelined plan's features and logits equal the
  port's single-device plan bit for bit, and match the reference's plan
  (``backend="ref"``) at the ROADMAP's tolerances;
- exact equals boxed and serial equals overlap, bit for bit; the data
  axis; the reference's error cases (``tests/test_pipeline_mesh.py``);
- the Engine's ``mesh`` rung (the counterparts of
  ``tests/test_pipeline_mesh.py::TestEngineOnMesh`` and
  ``tests/test_faults.py::TestMeshChaos``): answers equal the plan's, a
  tuned config and partial groups work, ``"auto"`` without a mesh raises,
  a device loss and a stall on ``mesh`` demote as the reference's do.

The reference's own mesh tests need 8 forced host devices and skip in a
plain run; a CPU mesh of the port is slots on ``cpu`` run in order and
needs no forced device count, so these run everywhere. There is no mesh
run of the reference to hold against (its shard_map fails under this
jax): the pipeline is held to the reference's own contract, that a
pipelined plan computes bit for bit what the single-device plan computes.

Tolerances against the reference: fp32 rtol 1e-4, atol 1e-5; under
fake-quant and int8 the features are equal except elements exactly one
quant step apart (tanh on the two sides of a rounding boundary), in at
most one frame, whose logits are then left out (as
``tests/test_torch_compiler.py`` and ``tests/test_torch_int8.py`` hold
the single-device plans).
"""
import pytest

torch = pytest.importorskip("torch")

# One intra-op thread: the suite runs in parallel workers, and idle
# OpenMP threads would spin on cores that timing tests elsewhere use.
torch.set_num_threads(1)

import dataclasses  # noqa: E402
import functools  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.dhm import compiler as jcompiler  # noqa: E402
from repro.core.dhm import pipeline as jpipeline  # noqa: E402
from repro.core.dhm.engine import forward as jax_forward  # noqa: E402
from repro.models.cnn import ALL_TOPOLOGIES as JAX_TOPOLOGIES  # noqa: E402
from repro.models.cnn import init_cnn as jax_init_cnn  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.dhm import (  # noqa: E402
    DeviceLoss,
    Engine,
    FaultPlan,
    QuantSpec,
    StalledDispatch,
    compile_dhm,
)
from repro_torch.core.dhm import pipeline as tpipeline  # noqa: E402
from repro_torch.core.dhm.engine import build_plan_pipeline  # noqa: E402
from repro_torch.core.dhm.pipeline import (  # noqa: E402
    EdgePlan,
    PipelineConfig,
    StageIOSpec,
    join_watchdogs,
    plan_edges,
)
from repro_torch.core.dhm.throughput import autotune_pipeline  # noqa: E402
from repro_torch.kernels import probe  # noqa: E402
from repro_torch.kernels.stream_conv.epilogue import stream_quant_spec  # noqa: E402
from repro_torch.launch.mesh import Mesh, Slot, data_axes, make_mesh, model_axes  # noqa: E402
from repro_torch.models.cnn import ALL_TOPOLOGIES  # noqa: E402

NAMES = sorted(JAX_TOPOLOGIES)
QUANTS = {
    "fp32": {},
    "fq6": dict(weight_bits=6, act_bits=6),
    "int8": dict(weight_bits=8, act_bits=8, int8_compute=True),
}
FP32 = dict(rtol=1e-4, atol=1e-5)
MAX_OFF_FRAMES = 1
M, MB = 3, 2


@functools.lru_cache(maxsize=None)
def _setup(name):
    """The reference init's params (numpy) and M x MB frames from a seed."""
    topo = JAX_TOPOLOGIES[name]
    params = jax.device_get(jax_init_cnn(jax.random.PRNGKey(0), topo))
    h, w = topo.input_shape
    x = np.random.default_rng(1).normal(size=(M * MB, h, w, topo.input_channels))
    return params, x.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _plan(name, quant="fp32", n_stages=1):
    params, _ = _setup(name)
    return compile_dhm(ALL_TOPOLOGIES[name], params_from_numpy(params, "cpu"),
                       quant=QuantSpec(**QUANTS[quant]), n_stages=n_stages, device="cpu")


@functools.lru_cache(maxsize=None)
def _jplan(name, quant="fp32", n_stages=1):
    params, _ = _setup(name)
    return jcompiler.compile_dhm(JAX_TOPOLOGIES[name], params, n_stages=n_stages,
                                 quant=jcompiler.QuantSpec(**QUANTS[quant]), backend="ref")


@functools.lru_cache(maxsize=None)
def _reference(name, quant):
    """(features, logits) of the reference plan on the frames, n_stages=1
    (on the ``ref`` backend every stage count computes the same)."""
    _, x = _setup(name)
    plan = _jplan(name, quant)
    return np.asarray(plan.features(jnp.asarray(x))), np.asarray(jax_forward(plan, jnp.asarray(x)))


def _mbs(name, m=M, mb=MB, seed=1):
    topo = ALL_TOPOLOGIES[name]
    h, w = topo.input_shape
    x = np.random.default_rng(seed).normal(size=(m, mb, h, w, topo.input_channels))
    return torch.from_numpy(x.astype(np.float32))


def _seq(plan, mbs):
    """The single-device plan at the pipeline's batch grain: one
    sequential run per µbatch."""
    with torch.no_grad():
        return torch.stack([plan.features(mbs[i]) for i in range(mbs.shape[0])])


def _sharded(plan, mbs, D):
    loc = mbs.shape[1] // D
    with torch.no_grad():
        return torch.cat([
            torch.stack([plan.features(mbs[i, d * loc:(d + 1) * loc]) for i in range(mbs.shape[0])])
            for d in range(D)
        ], dim=1)


def _stage_mesh(n, data=0):
    if data:
        return make_mesh((n, data), ("stage", "data"), device="cpu")
    return make_mesh((n,), ("stage",), device="cpu")


def _edge_fields(ep):
    return (ep.mode, ep.edge_shapes, ep.class_shapes, ep.edge_class,
            [ep.class_pairs(c) for c in range(ep.n_classes)], ep.class_bytes(),
            ep.class_bytes(1), ep.padding_fraction(), ep.n_edges, ep.n_classes)


def _assert_matches_reference(feats, logits, want_feats, want_logits, quant):
    if quant == "fp32":
        np.testing.assert_allclose(feats, want_feats, **FP32)
        np.testing.assert_allclose(logits, want_logits, **FP32)
        return
    bits = QUANTS[quant]["act_bits"]
    d = np.abs(feats - want_feats)
    off = d > 1e-6
    np.testing.assert_allclose(d[off], stream_quant_spec(bits).scale, rtol=1e-5)
    off_frames = off.reshape(off.shape[0], -1).any(axis=1)
    assert off_frames.sum() <= MAX_OFF_FRAMES, int(off.sum())
    np.testing.assert_allclose(logits[~off_frames], want_logits[~off_frames], **FP32)


# ---------------------------------------------------------------------------
# the mesh


def test_make_mesh_on_the_cpu_needs_no_forced_device_count():
    mesh = make_mesh((3, 2), ("stage", "data"), device="cpu")
    assert mesh.axis_names == ("stage", "data")
    assert mesh.shape == {"stage": 3, "data": 2} and mesh.size == 6
    assert len(mesh.slots) == 6 and all(s.stream is None for s in mesh.slots)
    assert {str(d) for d in mesh.devices} == {"cpu"}
    assert mesh.slot(2, 1).coords == (2, 1) == mesh.slot(stage=2, data=1).coords
    assert mesh.slot(stage=1).coords == (1, 0)
    assert data_axes(mesh) == ("data",) and model_axes(mesh) == ()
    with pytest.raises(ValueError, match="unknown mesh axes"):
        mesh.slot(model=0)
    for bad in (((2,), ("a", "b")), ((2, 2), ("a", "a")), ((0,), ("a",))):
        with pytest.raises(ValueError):
            make_mesh(*bad, device="cpu")


def test_make_mesh_raises_without_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((2,), ("stage",))


# ---------------------------------------------------------------------------
# edge planning


def _chain(mod, *shapes):
    return tuple(mod.StageIOSpec(in_shape=a, out_shape=b) for a, b in zip(shapes[:-1], shapes[1:]))


CHAINS = (
    ((8, 8, 4), (4, 4, 8), (4, 4, 8), (2, 2, 16)),
    ((8, 8, 4), (4, 4, 8), (2, 2, 16), (1, 1, 32)),
    ((8, 8, 4), (4, 4, 8)),
    ((4,), (2,), (3, 2), (6,), (2, 3)),
    ((16, 16, 4), (8, 8, 8), (4, 4, 16), (2, 2, 32)),
    ((12, 12, 6), (6, 6, 24), (3, 3, 48), (1, 1, 96)),
)


@pytest.mark.parametrize("chain", range(len(CHAINS)))
def test_plan_edges_equal_the_references_on_synthetic_chains(chain):
    for mode in ("auto", "exact", "boxed"):
        for max_classes in (1, 2, 3, 4):
            got = plan_edges(_chain(tpipeline, *CHAINS[chain]), mode=mode, max_classes=max_classes)
            want = jpipeline.plan_edges(_chain(jpipeline, *CHAINS[chain]), mode=mode,
                                        max_classes=max_classes)
            assert _edge_fields(got) == _edge_fields(want)
    for mod in (tpipeline, jpipeline):
        with pytest.raises(ValueError, match="edge mode"):
            mod.plan_edges(_chain(mod, (4,), (2,)), mode="wat")


@pytest.mark.parametrize("name", NAMES)
def test_plan_edges_equal_the_references_on_every_topology(name):
    for n_stages in range(1, len(ALL_TOPOLOGIES[name].conv_layers) + 1):
        plan, jplan = _plan(name, n_stages=n_stages), _jplan(name, n_stages=n_stages)
        assert plan.edge_shapes() == jplan.edge_shapes()
        for mode in ("auto", "exact", "boxed"):
            for max_classes in (1, 2, 4):
                assert _edge_fields(plan.edge_plan(mode=mode, max_classes=max_classes)) == \
                    _edge_fields(jplan.edge_plan(mode=mode, max_classes=max_classes))
        ep = plan.edge_plan()
        assert ep.mode == "exact" and ep.padding_fraction() == 0.0
        spec, jspec = plan.pipeline_spec(), jplan.pipeline_spec()
        assert [(io.in_shape, io.out_shape) for io in spec[2]] == \
            [(io.in_shape, io.out_shape) for io in jspec[2]]
        assert [len(p) for p in spec[1]] == [len(p) for p in jspec[1]]


def test_pipeline_config_and_boxing_helpers_match_the_reference():
    for kw in (dict(n_stages=0, n_microbatches=1), dict(n_stages=1, n_microbatches=0),
               dict(n_stages=2, n_microbatches=2, data_axis="stage"),
               dict(n_stages=2, n_microbatches=2, edge_mode="wat"),
               dict(n_stages=2, n_microbatches=2, max_edge_classes=0)):
        for mod in (tpipeline, jpipeline):
            with pytest.raises(ValueError):
                mod.PipelineConfig(**kw)
    assert tpipeline.EDGE_MODES == jpipeline.EDGE_MODES
    shapes = [(4, 4, 8), (2, 2, 16), (8,)]
    assert tpipeline._box_of(shapes) == jpipeline._box_of(shapes)
    a = np.random.default_rng(0).normal(size=(3, 2, 2, 5)).astype(np.float32)
    box = (3, 4, 4, 8)
    got = tpipeline._fit_elem(torch.from_numpy(a), box[1:])
    want = jpipeline._fit_elem(jnp.asarray(a), box[1:])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tpipeline._unfit_elem(got, (2, 2, 5)).numpy(), a)
    np.testing.assert_array_equal(tpipeline._fit(torch.from_numpy(a[0]), box[1:]).numpy(),
                                  np.asarray(jpipeline._fit(jnp.asarray(a[0]), box[1:])))
    np.testing.assert_array_equal(
        tpipeline._unfit(tpipeline._fit(torch.from_numpy(a[0]), box[1:]), (2, 2, 5)).numpy(), a[0])
    t = torch.from_numpy(a)
    assert tpipeline._fit_elem(t, (2, 2, 5)).data_ptr() == t.data_ptr()  # exact: a pure reshape


# ---------------------------------------------------------------------------
# the pipelined plans


@pytest.mark.parametrize("quant", sorted(QUANTS))
@pytest.mark.parametrize("name", NAMES)
def test_pipelined_plan_equals_the_single_device_plan_and_matches_the_reference(name, quant):
    """Every n_stages from 1 to L: the pipelined features equal the
    single-device plan's per-µbatch features bit for bit, the logits on
    them equal ``plan(x)`` bit for bit, and both match the reference."""
    _, x = _setup(name)
    want_feats, want_logits = _reference(name, quant)
    mbs = torch.from_numpy(x).reshape((M, MB) + x.shape[1:])
    for n_stages in range(1, len(ALL_TOPOLOGIES[name].conv_layers) + 1):
        plan = _plan(name, quant, n_stages)
        with torch.no_grad():
            feats = plan.run_pipelined(mbs, mesh=_stage_mesh(n_stages))
            assert torch.equal(feats, _seq(plan, mbs))
            flat = feats.reshape((M * MB,) + tuple(feats.shape[2:]))
            logits = plan.head_fn(flat)
            assert torch.equal(logits, plan(x))
        _assert_matches_reference(flat.numpy(), logits.numpy(), want_feats, want_logits, quant)


@pytest.mark.parametrize("quant", ["fp32", "fq6"])
@pytest.mark.parametrize("name", NAMES)
def test_exact_boxed_serial_and_overlap_are_bit_identical(name, quant):
    n_stages = min(3, len(ALL_TOPOLOGIES[name].conv_layers))
    plan = _plan(name, quant, n_stages)
    assert len({st.io.in_shape for st in plan.stages}) > 1  # heterogeneous stages
    mbs = _mbs(name)
    ref = _seq(plan, mbs)
    mesh = _stage_mesh(n_stages)
    for edge_mode in ("exact", "boxed"):
        for overlap in (False, True):
            out = plan.run_pipelined(mbs, mesh=mesh, edge_mode=edge_mode, overlap=overlap)
            assert torch.equal(out, ref), (edge_mode, overlap)


@pytest.mark.parametrize("n_microbatches", [1, 2, 3, 6])
def test_overlap_matches_serial(n_microbatches):
    plan = _plan("cifar10", "fp32", 3)
    mbs = _mbs("cifar10", m=n_microbatches)
    ref = _seq(plan, mbs)
    mesh = _stage_mesh(3)
    assert torch.equal(plan.run_pipelined(mbs, mesh=mesh, overlap=False), ref)
    assert torch.equal(plan.run_pipelined(mbs, mesh=mesh, overlap=True), ref)


@pytest.mark.parametrize("n_stages", [2, 3])
@pytest.mark.parametrize("overlap", [False, True])
def test_schedule_follows_the_references_ticks(n_stages, overlap):
    """Stage s takes µbatch t - s at tick t (t - 2s overlapped), over
    M + S - 1 ticks (M + 2(S - 1)); fill and drain ticks launch nothing:
    each stage body runs exactly M times, in µbatch order; every interior
    edge is handed off once per µbatch, in its class's buffer."""
    plan = _plan("cifar10", "fp32", n_stages)
    calls = []
    fns, params, ios = plan.pipeline_spec()

    def spy(s, fn):
        def body(p, x):
            calls.append((s, float(x.sum())))
            return fn(p, x)
        return body

    cfg = PipelineConfig(n_stages, 4, overlap=overlap)
    runner = tpipeline.build_pipeline([spy(s, f) for s, f in enumerate(fns)], params,
                                      mesh=_stage_mesh(n_stages), cfg=cfg, io_specs=ios)
    mbs = _mbs("cifar10", m=4)
    with probe.recording() as log:
        out = runner(mbs)
    assert torch.equal(out, _seq(plan, mbs))
    k = 2 if overlap else 1
    order = [(s, t - k * s) for t in range(4 + k * (n_stages - 1)) for s in range(n_stages)
             if 0 <= t - k * s < 4]
    assert [s for s, _ in calls] == [s for s, _ in order]
    assert [v for s, v in calls if s == 0] == [float(mbs[m].sum()) for m in range(4)]
    ep = runner.edge_plan
    assert sorted(log.transfers) == sorted(
        (ep.edge_class[e], (e, e + 1), (MB,) + tuple(ep.class_shapes[ep.edge_class[e]]))
        for e in range(n_stages - 1) for _ in range(4))


def test_data_axis_columns_pipeline_their_shards_bit_exact():
    plan = _plan("cifar10", "fp32", 3)
    mbs = _mbs("cifar10", m=3, mb=4)
    mesh = _stage_mesh(3, data=2)
    for overlap in (False, True):
        out = plan.run_pipelined(mbs, mesh=mesh, data_axis="data", overlap=overlap)
        assert torch.equal(out, _sharded(plan, mbs, 2))
    plan = _plan("svhn", "fq6", 3)
    mbs = _mbs("svhn", m=4, mb=4)
    out = plan.run_pipelined(mbs, mesh=mesh, data_axis="data", overlap=True)
    assert torch.equal(out, _sharded(plan, mbs, 2))


def test_the_references_error_cases_raise():
    plan2 = _plan("lenet5", "fp32", 2)
    with pytest.raises(ValueError, match="mesh axis"):
        plan2.run_pipelined(_mbs("lenet5"), mesh=_stage_mesh(4))
    plan3 = _plan("cifar10", "fp32", 3)
    with pytest.raises(ValueError, match="not divisible"):
        plan3.run_pipelined(_mbs("cifar10", mb=3), mesh=_stage_mesh(3, data=2), data_axis="data")
    runner = build_plan_pipeline(plan3, mesh=_stage_mesh(3), cfg=PipelineConfig(3, 2))
    with pytest.raises(ValueError, match="expected 2 microbatches"):
        runner(_mbs("cifar10", m=3))
    with pytest.raises(ValueError, match="element shape"):
        runner(_mbs("lenet5", m=2))
    with pytest.raises(ValueError, match="needs io_specs"):
        tpipeline.build_pipeline(*plan3.pipeline_spec()[:2], mesh=_stage_mesh(3),
                                 cfg=PipelineConfig(3, 2))
    fns, params, ios = plan3.pipeline_spec()
    with pytest.raises(ValueError, match="does not chain"):
        tpipeline.build_pipeline(fns, params, mesh=_stage_mesh(3), cfg=PipelineConfig(3, 2),
                                 io_specs=(ios[0], ios[2], ios[1]))
    bad = list(ios)
    bad[1] = StageIOSpec(in_shape=ios[1].in_shape, out_shape=(9, 9, 9))
    bad[2] = StageIOSpec(in_shape=(9, 9, 9), out_shape=ios[2].out_shape)
    runner = tpipeline.build_pipeline(fns, params, mesh=_stage_mesh(3), cfg=PipelineConfig(3, 2),
                                      io_specs=bad)
    with pytest.raises(ValueError, match="StageIOSpec promises"):
        runner(_mbs("cifar10", m=2))


def test_a_mesh_on_another_device_than_the_plans_raises():
    """No fallback: a CPU plan never runs on a mesh whose slots are on
    another device, nor a slot on the card runs a CPU plan's µbatches."""
    plan = _plan("lenet5", "fp32", 2)
    meta = Mesh(("stage",), (2,), [Slot(coords=(i,), device=torch.device("meta")) for i in range(2)])
    with pytest.raises(ValueError, match="cannot run a plan on cpu"):
        plan.run_pipelined(_mbs("lenet5"), mesh=meta)
    runner = tpipeline.build_pipeline(*plan.pipeline_spec()[:2], mesh=meta,
                                      cfg=PipelineConfig(2, M), io_specs=plan.pipeline_spec()[2])
    with pytest.raises(ValueError, match="no fallback between devices"):
        runner(_mbs("lenet5"))


def test_a_failed_stage_raises_through_apply():
    plan = _plan("lenet5", "fp32", 2)
    fns, params, ios = plan.pipeline_spec()

    def broken(p, x):
        raise RuntimeError("stage 1 launch failed")

    runner = tpipeline.build_pipeline([fns[0], broken], params, mesh=_stage_mesh(2),
                                      cfg=PipelineConfig(2, M), io_specs=ios)
    with pytest.raises(RuntimeError, match="stage 1 launch failed"):
        runner(_mbs("lenet5"))


def test_runner_reports_edge_path():
    plan = _plan("cifar10", "fp32", 3)
    mesh = _stage_mesh(3)
    auto = build_plan_pipeline(plan, mesh=mesh, cfg=PipelineConfig(3, 4))
    assert auto.edge_plan.mode == "exact" and auto.edge_plan.n_classes == 2
    assert auto.edge_plan.padding_fraction() == 0.0
    boxed = build_plan_pipeline(plan, mesh=mesh, cfg=PipelineConfig(3, 4, edge_mode="boxed"))
    assert boxed.edge_plan.mode == "boxed" and boxed.edge_plan.n_classes == 1
    assert boxed.edge_plan.padding_fraction() > 0.0
    squeezed = build_plan_pipeline(plan, mesh=mesh, cfg=PipelineConfig(3, 4, max_edge_classes=1))
    assert squeezed.edge_plan.mode == "boxed"
    assert isinstance(auto.edge_plan, EdgePlan)
    # Each slot holds its own stage's parameters (deviation (b): no boxing).
    assert [[len(p) for p in row] for row in auto.stacked_leaves] == [[1], [1], [1]]
    assert all(auto.stacked_leaves[s][0][0]["w"] is plan.stage_params(s)[0]["w"] for s in range(3))


def test_derive_io_specs_and_pipeline_forward_match_the_reference():
    """Heterogeneous single-layer stages from ``make_conv_stage``: the
    derived geometry equals the reference's ``jax.eval_shape`` chain, the
    pipelined stream equals the stages run in sequence bit for bit, and
    matches the reference's stage bodies run in sequence at fp32."""
    rng = np.random.default_rng(3)
    layer_kw = [dict(padding="SAME", act="relu", pool=2), dict(padding="SAME", act="tanh", pool=0),
                dict(padding="VALID", act="relu", pool=2)]
    chans = [3, 8, 12, 16]
    np_params = [{"w": (rng.normal(size=(3, 3, chans[i], chans[i + 1])) * 0.3).astype(np.float32),
                  "b": (rng.normal(size=(chans[i + 1],)) * 0.1).astype(np.float32)} for i in range(3)]
    t_fns = [tpipeline.make_conv_stage(**kw) for kw in layer_kw]
    j_fns = [jpipeline.make_conv_stage(backend="ref", **kw) for kw in layer_kw]
    t_params = [{k: torch.from_numpy(v) for k, v in p.items()} for p in np_params]
    j_params = [{k: jnp.asarray(v) for k, v in p.items()} for p in np_params]
    got = tpipeline.derive_io_specs(t_fns, t_params, (16, 16, 3))
    want = jpipeline.derive_io_specs(j_fns, j_params, (16, 16, 3))
    assert [(s.in_shape, s.out_shape) for s in got] == [(s.in_shape, s.out_shape) for s in want]
    x = rng.normal(size=(4, 2, 16, 16, 3)).astype(np.float32)
    out = tpipeline.pipeline_forward(t_fns, t_params, torch.from_numpy(x), mesh=_stage_mesh(3),
                                     cfg=PipelineConfig(3, 4))
    seq, jseq = [], []
    for m in range(4):
        h, jh = torch.from_numpy(x[m]), jnp.asarray(x[m])
        for s in range(3):
            h, jh = t_fns[s](t_params[s], h), j_fns[s](j_params[s], jh)
        seq.append(h)
        jseq.append(np.asarray(jh))
    assert torch.equal(out, torch.stack(seq))
    np.testing.assert_allclose(out.numpy(), np.stack(jseq), **FP32)


def test_pipeline_forward_homogeneous_sugar():
    """One shared stage body and params stacked on a leading stage axis
    (``stack_stage_params``), as the reference's sugar takes them."""
    rng = np.random.default_rng(4)
    fn = tpipeline.make_conv_stage(padding="SAME", act="tanh", pool=0)
    per = [{"w": torch.from_numpy((rng.normal(size=(3, 3, 4, 4)) * 0.3).astype(np.float32)),
            "b": torch.from_numpy((rng.normal(size=(4,)) * 0.1).astype(np.float32))} for _ in range(3)]
    stacked = tpipeline.stack_stage_params(per)
    assert stacked["w"].shape == (3, 3, 3, 4, 4)
    x = torch.from_numpy(rng.normal(size=(2, 2, 6, 6, 4)).astype(np.float32))
    out = tpipeline.pipeline_forward(fn, stacked, x, mesh=_stage_mesh(3), cfg=PipelineConfig(3, 2))
    want = []
    for m in range(2):
        h = x[m]
        for p in per:
            h = fn(p, h)
        want.append(h)
    assert torch.equal(out, torch.stack(want))


# ---------------------------------------------------------------------------
# the Engine's mesh rung


def _padded_direct(plan, x, group):
    """``plan`` on ``x`` padded to the engine's group, as the engine pads."""
    pad = -x.shape[0] % group
    xp = np.concatenate([x, np.zeros((pad,) + x.shape[1:], np.float32)])
    with torch.no_grad():
        return torch.cat([plan(xp[i:i + group]) for i in range(0, xp.shape[0], group)])[:x.shape[0]]


def _frames(name, n, seed):
    topo = ALL_TOPOLOGIES[name]
    h, w = topo.input_shape
    return np.random.default_rng(seed).normal(size=(n, h, w, topo.input_channels)).astype(np.float32)


@pytest.mark.parametrize("quant", sorted(QUANTS))
def test_engine_mesh_rung_serves_the_plans_answers(quant):
    """The Engine's pipelined path on a 2D (stage, data) mesh: every
    answer equals the plan on the same group bit for bit, and ``plan(x)``
    at fp32 (the reference's own test)."""
    plan = _plan("lenet5", quant, 2)
    eng = Engine(plan, microbatch=4, mesh=_stage_mesh(2, data=2), n_microbatches=3,
                 data_axis="data")
    assert eng.rung == "mesh" and eng.group == 12
    x = _frames("lenet5", 12, 3)
    out = eng.infer(x)
    assert torch.equal(out, _padded_direct(plan, x, 12))
    np.testing.assert_allclose(out.numpy(), plan(x).numpy(), rtol=1e-5, atol=1e-5)
    x2 = _frames("lenet5", 17, 4)  # two groups, the second padded
    assert torch.equal(eng.infer(x2), _padded_direct(plan, x2, 12))
    st = eng.stats()
    assert st.n_frames == 29 and st.frames_per_s > 0 and st.rung == "mesh"
    assert eng.demotions == [] and st.n_retries == 0


def test_engine_tuned_config():
    """A PipelineTuning overrides the engine's pipeline knobs (µbatch
    count, grain, overlap, edge path) and the served logits still match
    the single-device plan."""
    plan = _plan("lenet5", "fp32", 2)
    measured = [{
        "n_stages": 2, "n_microbatches": 2, "microbatch": 4,
        "data": 2, "overlap": True, "edge_mode": "boxed",
        "frames_per_s": 123.0,
    }]
    tuning = autotune_pipeline(plan, 4, measurements=measured)
    assert tuning.source == "measured" and tuning.overlap
    eng = Engine(plan, mesh=_stage_mesh(2, data=2), data_axis="data", tuning=tuning)
    assert eng.group == 8 and eng.overlap and eng.tuning is tuning
    assert eng._runner.edge_plan.mode == "boxed"
    x = _frames("lenet5", 8, 5)
    out = eng.infer(x)
    assert torch.equal(out, _padded_direct(plan, x, 8))
    np.testing.assert_allclose(out.numpy(), plan(x).numpy(), rtol=1e-5, atol=1e-5)


def test_engine_partial_group_padding():
    plan = _plan("lenet5", "fp32", 2)
    eng = Engine(plan, microbatch=2, mesh=_stage_mesh(2), n_microbatches=2)
    x = _frames("lenet5", 3, 4)
    out = eng.infer(x)
    assert out.shape == (3, 10)
    assert torch.equal(out, _padded_direct(plan, x, 4))
    np.testing.assert_allclose(out.numpy(), plan(x).numpy(), rtol=1e-5, atol=1e-5)


def test_engine_auto_tuning_needs_a_mesh_and_tunes_with_one():
    plan = _plan("lenet5", "fp32", 2)
    with pytest.raises(ValueError, match="needs a mesh"):
        Engine(plan, n_microbatches="auto")
    eng = Engine(plan, mesh=_stage_mesh(2), n_microbatches="auto")
    t = eng.tuning
    assert t.source == "model" and t == autotune_pipeline(plan, 2)
    assert (eng.microbatch, eng.n_microbatches, eng.overlap) == (t.microbatch, t.n_microbatches,
                                                                 t.overlap)
    assert eng.rung == "mesh"
    x = _frames("lenet5", 5, 6)
    assert torch.equal(eng.infer(x), _padded_direct(plan, x, eng.group))
    with pytest.raises(ValueError, match="n_microbatches must be >= 1"):
        Engine(plan, mesh=_stage_mesh(2), n_microbatches=0)


def test_engine_refuses_a_mesh_on_another_device_and_starts_on_fused():
    """The mesh rung's build fails its warmup on a mesh of another device
    type; the ladder records the demotion and serves on ``fused``."""
    plan = _plan("lenet5", "fp32", 2)
    meta = Mesh(("stage",), (2,), [Slot(coords=(i,), device=torch.device("meta")) for i in range(2)])
    eng = Engine(plan, microbatch=2, mesh=meta, n_microbatches=2)
    assert eng.rung == "fused"
    assert eng.demotions[0]["rung"] == "mesh" and "cannot run a plan" in eng.demotions[0]["reason"]


def _mesh_engine(**kw):
    plan = _plan("lenet5", "fp32", 2)
    eng = Engine(plan, microbatch=2, mesh=_stage_mesh(2), n_microbatches=2,
                 retry_backoff_s=1e-4, **kw)
    return plan, eng


def test_device_loss_on_the_mesh_rung_demotes_to_single_device():
    plan, eng = _mesh_engine(
        fault_plan=FaultPlan([DeviceLoss(at=0, times=None, rung="mesh")]))
    assert eng.rung == "mesh"
    x = _frames("lenet5", 4, 1)
    got = eng.infer(x)
    assert torch.equal(got, _padded_direct(plan, x, 4))
    assert eng.rung == "fused"
    assert [d["rung"] for d in eng.demotions] == ["mesh"]
    assert eng.stats().n_retries == 0 and eng.stats().n_demotions == 1


def test_stalled_dispatch_on_the_mesh_rung_times_out_and_demotes():
    """A stall past the watchdog raises CollectiveTimeout and demotes to
    fused; the abandoned attempt wakes when its watchdog gives up and
    runs nothing on the mesh afterwards."""
    plan, eng = _mesh_engine(
        fault_plan=FaultPlan([StalledDispatch(at=0, times=None, stall_s=5.0, rung="mesh")]),
        dispatch_timeout_s=0.3)
    calls, mesh_fwd = [], eng._fwd
    eng._fwd = lambda xb: calls.append(1) or mesh_fwd(xb)
    x = _frames("lenet5", 4, 1)
    t0 = time.perf_counter()
    got = eng.infer(x)
    assert join_watchdogs(10.0) == 0
    assert time.perf_counter() - t0 < 5.0
    assert torch.equal(got, _padded_direct(plan, x, 4))
    assert calls == [] and eng.rung == "fused"
    assert eng.stats().n_demotions == 1
    assert "did not complete" in eng.demotions[0]["reason"]


def test_apply_with_timeout_claims_its_watch_before_launching():
    plan = _plan("lenet5", "fp32", 2)
    runner = build_plan_pipeline(plan, mesh=_stage_mesh(2), cfg=PipelineConfig(2, M))
    mbs = _mbs("lenet5")
    out = runner.apply_with_timeout(runner.stacked_leaves, mbs, timeout_s=30.0)
    assert torch.equal(out, _seq(plan, mbs))
    watch = tpipeline.Watch()
    watch.give_up()
    with probe.recording() as log, pytest.raises(tpipeline.CollectiveTimeout, match="gave up"):
        runner.apply_with_timeout(runner.stacked_leaves, mbs, timeout_s=None, watch=watch)
    assert log.transfers == [] and log.dispatches == []


def test_dataclasses_of_the_pipeline_are_frozen():
    cfg = PipelineConfig(2, 2)
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.n_stages = 3
