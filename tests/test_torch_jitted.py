"""The plan's jitted closure in the port on the CPU, held against the
reference's (``repro.core.dhm.engine.plan_jitted_forward``).

On a CPU plan the closure (``engine.JittedForward``) is the eager
composition with the reference's surface: cached per plan and donation
flag, ``_cache_size()`` counting the input shapes, ``input_buffer`` for
the donating caller. The card's CUDA graphs are held in
``test_torch_jitted_card.py``.

- the reference's own tests of the closure, restated
  (``tests/test_engine.py``: one closure across three flushes, the
  undonated engine, the closure cached per plan and per flag;
  ``tests/test_fusion.py``: ``plan(x)`` reuses one closure, and the
  donating closure equals ``plan(x)``);
- ``plan.jitted_forward()(x)`` against the reference's on the same numpy
  params and frames for the five topologies: fp32 at rtol 1e-4 / atol
  1e-5, the int8 plan and the integer pow2 head (on-grid frames) bit for
  bit, the reference on its ``ref`` and ``pallas`` backends;
- the Engine's fused and per-layer rungs are closures of this kind, with
  the engine's donation; a donating engine stages into the closure's
  input buffer, an undonated one into a fresh tensor; a demotion serves
  from the per-layer closure; four threads on one closure;
- the launch accounting a graph's capture and replays use
  (``kernels/probe.py``: ``counted``, ``uncount``, ``replayed``);
- ``COLLECTIVE_OPS`` and ``parse_collectives`` of the dry run over the
  port's op log.
"""
import pytest

torch = pytest.importorskip("torch")

# One intra-op thread: the suite runs in parallel workers, and idle
# OpenMP threads would spin on cores that timing tests elsewhere use.
torch.set_num_threads(1)

import functools  # noqa: E402
import threading  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.dhm import compiler as jcompiler  # noqa: E402
from repro.launch import dryrun as jdryrun  # noqa: E402
from repro.launch import hlo_analysis as jhlo  # noqa: E402
from repro.models.cnn import ALL_TOPOLOGIES as JAX_TOPOLOGIES  # noqa: E402
from repro.models.cnn import init_cnn as jax_init_cnn  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.dhm import DispatchError, Engine, FaultPlan, QuantSpec, compile_dhm  # noqa: E402
from repro_torch.core.dhm.engine import JittedForward, forward, plan_jitted_forward  # noqa: E402
from repro_torch.kernels import probe  # noqa: E402
from repro_torch.kernels.pow2_matmul import pow2 as kpow2  # noqa: E402
from repro_torch.kernels.stream_conv import conv as kconv  # noqa: E402
from repro_torch.kernels.stream_conv.epilogue import stream_quant_spec  # noqa: E402
from repro_torch.launch import dryrun as tdryrun  # noqa: E402
from repro_torch.launch import hlo_analysis as thlo  # noqa: E402
from repro_torch.models.cnn import ALL_TOPOLOGIES  # noqa: E402

NAMES = sorted(JAX_TOPOLOGIES)
FP32 = dict(rtol=1e-4, atol=1e-5)
BITS = 8


@functools.lru_cache(maxsize=None)
def _params(name):
    """The reference init's params, as numpy."""
    return jax.device_get(jax_init_cnn(jax.random.PRNGKey(0), JAX_TOPOLOGIES[name]))


def _frames(name, n=2, seed=1, grid=False):
    topo = JAX_TOPOLOGIES[name]
    h, w = topo.input_shape
    x = np.random.default_rng(seed).normal(size=(n, h, w, topo.input_channels))
    if grid:  # snapped onto the 8-bit stream grid (the int8 plans' exact frames)
        spec = stream_quant_spec(BITS)
        x = np.clip(np.round(x / spec.scale), spec.qmin, spec.qmax) * spec.scale
    return x.astype(np.float32)


def _quant(kind, name):
    n = len(JAX_TOPOLOGIES[name].conv_layers)
    return {
        "fp32": {},
        "int8": dict(weight_bits=BITS, act_bits=BITS, int8_compute=True),
        "int_pow2_head": dict(act_bits=BITS, pow2_weights=True, int8_compute=True,
                              per_layer_bits=(BITS,) * n),
    }[kind]


def _plan(name="lenet5", **quant):
    return compile_dhm(ALL_TOPOLOGIES[name], params_from_numpy(_params(name), "cpu"),
                       quant=QuantSpec(**quant), device="cpu")


# ---------------------------------------------------------------------------
# The reference's own tests of the closure, restated.


def test_no_retrace_across_flushes():
    """tests/test_engine.py: the donated closure is built once; repeated
    flushes reuse it (one input shape in its cache)."""
    plan = _plan()
    eng = Engine(plan, microbatch=4)
    for seed in range(3):
        eng.infer(_frames("lenet5", 4, seed=seed))
    assert plan_jitted_forward(plan, donate=True)._cache_size() == 1
    assert eng._fwd is plan_jitted_forward(plan, donate=True)


def test_undonated_engine():
    """tests/test_engine.py: an engine that does not donate serves
    plan(x)'s logits (here bit for bit: the same composition)."""
    plan = _plan()
    eng = Engine(plan, microbatch=2, donate=False, warmup=False)
    x = _frames("lenet5", 2)
    out = eng.infer(x)
    np.testing.assert_allclose(out.numpy(), plan(x).numpy(), **FP32)
    np.testing.assert_array_equal(out.numpy(), forward(plan, torch.from_numpy(x)).numpy())
    assert eng._fwd is plan_jitted_forward(plan, donate=False)


def test_jitted_forward_cached_per_plan():
    """tests/test_engine.py: one closure per plan and per donate flag."""
    plan = _plan()
    assert plan.jitted_forward() is plan.jitted_forward()
    assert plan.jitted_forward(donate=True) is not plan.jitted_forward()
    assert plan.jitted_forward(donate=True) is plan_jitted_forward(plan, donate=True)
    assert _plan().jitted_forward() is not plan.jitted_forward()


def test_call_reuses_one_jitted_closure():
    """tests/test_fusion.py: ``plan(x)`` runs one cached closure, never a
    new one; the donating closure is a separate entry and gives
    ``plan(x)``'s logits."""
    plan = _plan()
    x = _frames("lenet5")
    first = plan.jitted_forward()
    for _ in range(4):
        plan(x)
    assert plan.jitted_forward() is first
    assert first._cache_size() == 1
    donating = plan.jitted_forward(donate=True)
    assert donating is not first
    out = donating(torch.from_numpy(x.copy()))
    np.testing.assert_allclose(out.numpy(), plan(x).numpy(), rtol=1e-6, atol=1e-6)


def test_cache_counts_input_shapes_and_dtypes():
    plan = _plan()
    fwd = plan.jitted_forward()
    for n in (1, 2, 2, 3, 1):
        plan(_frames("lenet5", n))
    assert fwd._cache_size() == 3
    fwd(torch.from_numpy(_frames("lenet5", 2)).double().float())
    assert fwd._cache_size() == 3


# ---------------------------------------------------------------------------
# The closure against the reference's, five topologies.


@pytest.mark.parametrize("backend", ["ref", "pallas"])
@pytest.mark.parametrize("kind", ["fp32", "int8", "int_pow2_head"])
@pytest.mark.parametrize("name", NAMES)
def test_jitted_forward_matches_reference(name, kind, backend):
    params, q = _params(name), _quant(kind, name)
    x = _frames(name, grid=kind != "fp32")
    jplan = jcompiler.compile_dhm(JAX_TOPOLOGIES[name], params, quant=jcompiler.QuantSpec(**q),
                                  backend=backend)
    plan = _plan(name, **q)
    want = np.asarray(jplan.jitted_forward()(jnp.asarray(x)))
    got = plan.jitted_forward()(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    if kind == "fp32":
        np.testing.assert_allclose(got.numpy(), want, **FP32)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), forward(plan, torch.from_numpy(x)).numpy())


# ---------------------------------------------------------------------------
# Donation, staging and the Engine's rungs.


def test_donating_call_on_its_buffer_equals_eager_and_leaves_undonated_input():
    plan = _plan("cifar10", **_quant("int8", "cifar10"))
    x = torch.from_numpy(_frames("cifar10", 3, grid=True))
    kept = x.clone()
    want = forward(plan, x)
    assert torch.equal(plan.jitted_forward()(x), want)
    assert torch.equal(x, kept)  # donate=False leaves the caller's tensor as it was
    fwd = plan.jitted_forward(donate=True)
    buf = fwd.input_buffer(tuple(x.shape))
    assert fwd.input_buffer(tuple(x.shape)) is buf and buf.dtype == torch.float32
    buf.copy_(x)
    assert torch.equal(fwd(buf), want)
    assert fwd._cache_size() == 1


@pytest.mark.parametrize("donate", [True, False])
def test_engine_stages_into_the_donating_closures_buffer(donate):
    plan = _plan()
    eng = Engine(plan, microbatch=4, donate=donate)
    frames = _frames("lenet5", 4, seed=5)
    fwd = eng._fwd
    assert isinstance(fwd, JittedForward) and fwd.donate is donate
    with fwd.lock:
        staged = eng._stage(frames, fwd)
        buf = fwd.input_buffer(frames.shape)
    assert (staged.data_ptr() == buf.data_ptr()) is donate
    np.testing.assert_array_equal(staged.numpy(), frames)
    assert eng._stage(frames).data_ptr() != buf.data_ptr()  # no closure: a fresh tensor
    np.testing.assert_array_equal(eng.infer(frames).numpy(),
                                  forward(plan, torch.from_numpy(frames)).numpy())


@pytest.mark.parametrize("donate", [True, False])
def test_engine_rungs_are_jitted_closures_with_the_engines_donation(donate):
    plan = _plan("cifar10", **_quant("int_pow2_head", "cifar10"))
    eng = Engine(plan, microbatch=2, donate=donate, warmup=False)
    rungs = dict(eng._ladder)
    fused, per_layer = rungs["fused"](), rungs["per_layer"]()
    assert fused is plan_jitted_forward(plan, donate=donate)
    assert isinstance(per_layer, JittedForward) and per_layer.donate is donate
    x = torch.from_numpy(_frames("cifar10", 2, grid=True))
    plan0 = compile_dhm(ALL_TOPOLOGIES["cifar10"], params_from_numpy(_params("cifar10"), "cpu"),
                        quant=QuantSpec(**_quant("int_pow2_head", "cifar10")), device="cpu",
                        vmem_budget=0)
    assert torch.equal(per_layer(x), forward(plan0, x))
    assert torch.equal(fused(x), forward(plan, x))


def test_demotion_serves_from_the_per_layer_closure():
    """A persistent dispatch error demotes the fused rung; the per-layer
    rung then serves through its own closure, its warm-up probe its first
    call, with the vmem_budget=0 plan's logits."""
    plan = _plan()
    faults = FaultPlan([DispatchError(at=0, times=3)])
    eng = Engine(plan, microbatch=2, fault_plan=faults, max_retries=2, retry_backoff_s=0.0)
    x = _frames("lenet5", 2, seed=3)
    out = eng.infer(x)
    assert eng.rung == "per_layer"
    assert [d["rung"] for d in eng.demotions] == ["fused"]
    assert isinstance(eng._fwd, JittedForward) and eng._fwd._cache_size() == 1
    plan0 = compile_dhm(ALL_TOPOLOGIES["lenet5"], params_from_numpy(_params("lenet5"), "cpu"),
                        device="cpu", vmem_budget=0)
    np.testing.assert_array_equal(out.numpy(), forward(plan0, torch.from_numpy(x)).numpy())


def test_four_threads_on_one_closure():
    plan = _plan()
    fwd = plan.jitted_forward()
    xs = [_frames("lenet5", 2, seed=s) for s in range(8)]
    got = [None] * len(xs)

    def work(i):
        for j in range(i, len(xs), 4):
            got[j] = fwd(torch.from_numpy(xs[j]))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for x, out in zip(xs, got):
        assert torch.equal(out, forward(plan, torch.from_numpy(x)))
    assert fwd._cache_size() == 1


# ---------------------------------------------------------------------------
# Launch accounting of a graph's capture and replays.


def test_launch_tables_are_registered_by_kernel_name():
    for name in kconv.LAUNCHES:
        assert probe._TABLES[name] is kconv.LAUNCHES
    for name in kpow2.LAUNCHES:
        assert probe._TABLES[name] is kpow2.LAUNCHES


def test_uncount_and_replayed_adjust_the_counts_and_the_open_log():
    before = dict(kconv.LAUNCHES), dict(kpow2.LAUNCHES)
    launches = (("stream_conv_pyramid", 1024), ("stream_conv_fused", 2048), ("pow2_matmul", 0))
    try:
        with probe.recording() as log:
            log.phase = "replay"
            probe.replayed(launches)
            probe.replayed(launches[:1])
        assert log.launches == [("replay", "stream_conv_pyramid", 1024),
                                ("replay", "stream_conv_fused", 2048),
                                ("replay", "pow2_matmul", 0),
                                ("replay", "stream_conv_pyramid", 1024)]
        assert kconv.LAUNCHES["stream_conv_pyramid"] == before[0]["stream_conv_pyramid"] + 2
        assert kpow2.LAUNCHES["pow2_matmul"] == before[1]["pow2_matmul"] + 1
        probe.uncount(log.launches)
        assert (dict(kconv.LAUNCHES), dict(kpow2.LAUNCHES)) == before
        probe.replayed(launches[:1])  # no log open: the counts alone
        assert kconv.LAUNCHES["stream_conv_pyramid"] == before[0]["stream_conv_pyramid"] + 1
    finally:
        kconv.LAUNCHES.update(before[0])
        kpow2.LAUNCHES.update(before[1])


def test_cpu_closure_launches_nothing():
    plan = _plan("cifar10")
    before = dict(kconv.LAUNCHES), dict(kpow2.LAUNCHES)
    with probe.recording() as log:
        plan(_frames("cifar10"))
    assert log.launches == [] and (dict(kconv.LAUNCHES), dict(kpow2.LAUNCHES)) == before
    assert [d[2] for d in log.dispatches] == [True] * len(log.dispatches)  # plain versions


# ---------------------------------------------------------------------------
# The dry run's collectives.


def test_collective_ops_are_the_references():
    assert tdryrun.COLLECTIVE_OPS == jdryrun.COLLECTIVE_OPS == jhlo.COLLECTIVE_OPS
    assert thlo.COLLECTIVE_OPS == jhlo.COLLECTIVE_OPS
    assert set(thlo.C10D_COLLECTIVES.values()) == set(thlo.COLLECTIVE_OPS)
    for op in thlo.C10D_COLLECTIVES:
        ns, name = op.split(".", 1)
        assert hasattr(getattr(torch.ops, ns), name), op


def test_parse_collectives_counts_c10d_ops_and_their_bytes():
    log = (
        "%0 = _c10d_functional.all_reduce.default op (f32[4,8]#0:128) -> (f32[4,8]#1:128) @ a.py:1\n"
        "%1 = _c10d_functional.wait_tensor.default op (f32[4,8]#1:128) -> (f32[4,8]#1:128v) @ a.py:2\n"
        "%2 = _c10d_functional.all_gather_into_tensor.default op (bf16[2,8]#2:32) -> "
        "(bf16[8,8]#3:128) @ a.py:3\n"
        "%3 = aten.mm.default op (f32[4,8]#1:128, f32[8,8]#4:256) -> (f32[4,8]#5:128) @ a.py:4\n"
    )
    stats = tdryrun.parse_collectives(log)
    assert list(stats) == list(jdryrun.COLLECTIVE_OPS)
    assert stats["all-reduce"] == {"count": 1, "operand_bytes": 128, "result_bytes": 128}
    assert stats["all-gather"] == {"count": 1, "operand_bytes": 32, "result_bytes": 128}
    assert all(stats[k]["count"] == 0
               for k in ("reduce-scatter", "all-to-all", "collective-permute"))
    assert tdryrun.parse_collectives(thlo.parse_computations(log)) == stats


def test_a_one_card_step_has_no_collectives():
    plan = _plan()
    _, rec, _ = thlo.record(lambda x: forward(plan, x), torch.from_numpy(_frames("lenet5")))
    stats = tdryrun.parse_collectives(thlo.format_log(rec.instrs))
    assert rec.instrs and all(v == {"count": 0, "operand_bytes": 0, "result_bytes": 0}
                              for v in stats.values())
