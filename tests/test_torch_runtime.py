"""The port's optimizer, checkpoints, tree walk and resilient trainer on
the CPU: the reference's own ``test_runtime.py`` assertions on the port,
and the port against the reference on the same numpy inputs.

Tolerances: AdamW, clipping and the schedules at rtol 1e-6, atol 1e-7
(the same float32 formula on both sides, each transcendental of its own
library); int8 compression codes bit for bit, their scales and residuals
at the same fp32 tolerance; checkpoints and tree order exact.
"""
import pytest

torch = pytest.importorskip("torch")

# One intra-op thread: the suite runs in parallel workers, and idle
# OpenMP threads would spin on cores that timing tests elsewhere use.
torch.set_num_threads(1)

import os  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import load_pytree as jax_load_pytree  # noqa: E402
from repro.checkpoint import save_pytree as jax_save_pytree  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.optim.compression import ef_init as jax_ef_init  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, load_pytree, save_pytree  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    AdamWConfig,
    OptState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    compress_grads_int8,
    constant_schedule,
    cosine_schedule,
    decompress_grads_int8,
    global_norm,
    linear_warmup_cosine,
)
from repro_torch.optim.compression import ef_init  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    ElasticMesh,
    FaultInjector,
    NodeFailure,
    ResilientTrainer,
    StragglerMonitor,
)
from repro_torch.tree_util import tree_flatten, tree_leaves, tree_map  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-7)


def _np_tree(seed=0):
    """A params-like tree of numpy arrays (dict keys out of order on
    purpose: the walk sorts them)."""
    rng = np.random.default_rng(seed)
    return {
        "fc": [{"w": rng.normal(size=(6, 3)).astype(np.float32),
                "b": rng.normal(size=(3,)).astype(np.float32)}],
        "conv": [{"w": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
                  "b": np.zeros(4, np.float32)}],
    }


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _to_numpy(tree):
    return tree_map(lambda t: t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t), tree)


# -- the tree walk -------------------------------------------------------------


@pytest.mark.parametrize("tree", [
    {"b": 1.0, "a": [2.0, {"d": 3.0, "c": (4.0, None)}]},
    _np_tree(),
    ({"x": 1.0}, [], None, (2.0,)),
])
def test_tree_order_and_rendering_are_jaxs(tree):
    leaves, treedef = tree_flatten(tree)
    jleaves, jdef = jax.tree_util.tree_flatten(tree)
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        assert a is b
    assert str(treedef) == str(jdef)
    assert tree_flatten(treedef.unflatten(leaves))[1] == treedef


def test_opt_state_walks_as_the_references():
    p = _np_tree()
    jdef = jax.tree_util.tree_flatten((p, joptim.adamw_init(p, joptim.AdamWConfig())))[1]
    tp = _to_torch(p)
    leaves, tdef = tree_flatten((tp, adamw_init(tp, AdamWConfig())))
    assert str(tdef) == str(jdef)
    assert len(leaves) == jdef.num_leaves


# -- optimizer parity ----------------------------------------------------------


@pytest.mark.parametrize("keep_master_copy", [False, True])
def test_adamw_update_matches_the_reference(keep_master_copy):
    jcfg = joptim.AdamWConfig(weight_decay=0.05, keep_master_copy=keep_master_copy)
    tcfg = AdamWConfig(weight_decay=0.05, keep_master_copy=keep_master_copy)
    p = _np_tree(0)
    jp, jst = jax.tree_util.tree_map(jnp.asarray, p), joptim.adamw_init(p, jcfg)
    tp = _to_torch(p)
    tst = adamw_init(tp, tcfg)
    for step in range(5):
        g = _np_tree(10 + step)
        lr = 1e-2 * (step + 1)
        jp, jst = joptim.adamw_update(jax.tree_util.tree_map(jnp.asarray, g), jst, jp, jcfg,
                                      jnp.asarray(lr, jnp.float32))
        tp, tst = adamw_update(_to_torch(g), tst, tp, tcfg, lr)
    assert int(tst.step) == int(jst.step) == 5 and tst.step.dtype == torch.int32
    for got, want in ((tp, jp), (tst.m, jst.m), (tst.v, jst.v)):
        for a, b in zip(tree_leaves(_to_numpy(got)), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a, np.asarray(b), **TOL)
    if keep_master_copy:
        for a, b in zip(tree_leaves(_to_numpy(tst.master)), jax.tree_util.tree_leaves(jst.master)):
            np.testing.assert_allclose(a, np.asarray(b), **TOL)
    else:
        assert tst.master is None and jst.master is None


def test_adamw_master_copy_keeps_bf16_params_in_fp32():
    cfg = AdamWConfig(keep_master_copy=True)
    p = {"w": torch.full((4,), 1.0, dtype=torch.bfloat16)}
    st = adamw_init(p, cfg)
    assert st.master["w"].dtype == torch.float32
    p2, st2 = adamw_update({"w": torch.full((4,), 0.5, dtype=torch.bfloat16)}, st, p, cfg, 1e-3)
    assert p2["w"].dtype == torch.bfloat16 and st2.master["w"].dtype == torch.float32
    assert float(st2.master["w"][0]) != 1.0 and float(p["w"][0]) == 1.0  # nothing in place


def test_clipping_matches_the_reference():
    g = _np_tree(3)
    want, wnorm = joptim.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, g), 1.0)
    got, norm = clip_by_global_norm(_to_torch(g), 1.0)
    np.testing.assert_allclose(float(norm), float(wnorm), **TOL)
    np.testing.assert_allclose(float(global_norm(_to_torch(g))), float(joptim.global_norm(g)), **TOL)
    for a, b in zip(tree_leaves(_to_numpy(got)), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


@pytest.mark.parametrize("which", ["constant", "cosine", "warmup_cosine"])
def test_schedules_match_the_reference(which):
    make = {
        "constant": (lambda m: m.constant_schedule(3e-3)),
        "cosine": (lambda m: m.cosine_schedule(3e-3, 50, final_frac=0.2)),
        "warmup_cosine": (lambda m: m.linear_warmup_cosine(3e-3, warmup_steps=20, total_steps=60)),
    }[which]
    f, jf = make(toptim), make(joptim)
    for s in range(0, 70, 3):
        got = f(s)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(jf(jnp.asarray(s))), **TOL)
        assert float(f(torch.tensor(s))) == float(got)


def test_int8_compression_codes_equal_the_references():
    g = _np_tree(4)
    jef = jax_ef_init(g)
    ef = ef_init(_to_torch(g))
    for step in range(3):
        gs = _np_tree(20 + step)
        jcodes, jscales, jef = joptim.compress_grads_int8(jax.tree_util.tree_map(jnp.asarray, gs), jef)
        codes, scales, ef = compress_grads_int8(_to_torch(gs), ef)
        for a, b in zip(tree_leaves(codes), jax.tree_util.tree_leaves(jcodes)):
            assert a.dtype == torch.int8
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for got, want in ((scales, jscales), (ef.residual, jef.residual),
                          (decompress_grads_int8(codes, scales),
                           joptim.decompress_grads_int8(jcodes, jscales))):
            for a, b in zip(tree_leaves(_to_numpy(got)), jax.tree_util.tree_leaves(want)):
                np.testing.assert_allclose(a, np.asarray(b), **TOL)
    codes, _, _ = compress_grads_int8(_to_torch(g))  # no error feedback
    jcodes, _, _ = joptim.compress_grads_int8(jax.tree_util.tree_map(jnp.asarray, g))
    for a, b in zip(tree_leaves(codes), jax.tree_util.tree_leaves(jcodes)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -- checkpoints across the two packages ----------------------------------------


def _state_pair():
    """The same (params, AdamW state) in both packages."""
    p = _np_tree(5)
    jcfg, tcfg = joptim.AdamWConfig(keep_master_copy=True), AdamWConfig(keep_master_copy=True)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jst = joptim.adamw_update(jax.tree_util.tree_map(jnp.asarray, _np_tree(6)),
                              joptim.adamw_init(jp, jcfg), jp, jcfg, jnp.asarray(0.1))
    tp = _to_torch(p)
    tst = adamw_update(_to_torch(_np_tree(6)), adamw_init(tp, tcfg), tp, tcfg, 0.1)
    return (jst[0], jst[1]), (tst[0], tst[1])


def test_a_reference_checkpoint_loads_in_the_port(tmp_path):
    jstate, tstate = _state_pair()
    jax_save_pytree(str(tmp_path / "ck"), jstate)
    like = tree_map(torch.zeros_like, tstate)
    got = load_pytree(str(tmp_path / "ck"), like)
    assert isinstance(got[1], OptState) and got[1].step.dtype == torch.int32
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(jstate)):
        assert isinstance(a, torch.Tensor)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_a_port_checkpoint_loads_in_the_reference(tmp_path):
    jstate, tstate = _state_pair()
    save_pytree(str(tmp_path / "ck"), tstate)
    with open(tmp_path / "ck" / "meta.json") as f:
        assert f.read() == (
            '{"n_leaves": %d, "treedef": "%s"}'
            % (len(jax.tree_util.tree_leaves(jstate)), jax.tree_util.tree_structure(jstate))
        )
    got = jax_load_pytree(str(tmp_path / "ck"), jstate)
    for a, b in zip(jax.tree_util.tree_leaves(got), tree_leaves(tstate)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# -- the reference's own assertions (tests/test_runtime.py), on the port --------


class TestCheckpointStore:
    def test_roundtrip(self, tmp_path):
        tree = {"a": torch.arange(6).reshape(2, 3), "b": [torch.ones(4), {"c": 2.5}]}
        save_pytree(str(tmp_path / "ck"), tree)
        out = load_pytree(str(tmp_path / "ck"), tree)
        assert torch.equal(out["a"], tree["a"])
        assert torch.equal(out["b"][0], tree["b"][0])
        assert float(out["b"][1]["c"]) == 2.5

    def test_shape_mismatch_raises(self, tmp_path):
        save_pytree(str(tmp_path / "ck"), {"a": torch.zeros(3)})
        with pytest.raises(ValueError):
            load_pytree(str(tmp_path / "ck"), {"a": torch.zeros(4)})

    def test_atomic_no_tmp_left(self, tmp_path):
        save_pytree(str(tmp_path / "ck"), {"a": torch.zeros(3)})
        assert not os.path.exists(str(tmp_path / "ck.tmp"))

    def test_manager_retention(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
        for s in (10, 20, 30):
            mgr.save(s, {"x": torch.full((2,), float(s))})
        assert mgr.all_steps() == [20, 30]
        state, step = mgr.restore({"x": torch.zeros(2)})
        assert step == 30
        assert float(state["x"][0]) == 30

    def test_manager_async(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=3, async_write=True)
        mgr.save(1, {"x": torch.ones(3)})
        mgr.wait()
        assert mgr.latest_step() == 1


def _quadratic_problem():
    """Tiny strongly-convex training problem for driver tests."""
    target = torch.tensor([1.0, -2.0, 3.0])
    cfg = AdamWConfig(weight_decay=0.0)

    def step_fn(state, batch, step):
        params, opt = state

        def loss(p):
            return torch.sum((p - target) ** 2) + 0.1 * torch.sum(p * batch)

        p = params.detach().requires_grad_()
        (g,) = torch.autograd.grad(loss(p), [p])
        params, opt = adamw_update(g, opt, params, cfg, 0.05)
        return (params, opt), {"loss": float(loss(params))}

    def batch_fn(step):
        return torch.sin(torch.arange(3) + step)  # deterministic by step

    params0 = torch.zeros(3)
    state0 = (params0, adamw_init(params0, cfg))
    return step_fn, batch_fn, state0


class TestResilientTrainer:
    def test_survives_failures_and_matches_clean_run(self, tmp_path):
        step_fn, batch_fn, state0 = _quadratic_problem()

        clean = ResilientTrainer(
            step_fn, batch_fn,
            CheckpointManager(str(tmp_path / "clean"), async_write=False),
            ckpt_every=5,
        )
        clean_state, _ = clean.run(state0, num_steps=30)

        faulty = ResilientTrainer(
            step_fn, batch_fn,
            CheckpointManager(str(tmp_path / "faulty"), async_write=False),
            ckpt_every=5,
            fault_injector=FaultInjector(fail_at_steps=(7, 19, 23)),
        )
        faulty_state, _ = faulty.run(state0, num_steps=30)
        assert faulty.restarts == 3
        # Deterministic replay: identical final parameters.
        np.testing.assert_allclose(
            faulty_state[0].numpy(), clean_state[0].numpy(), atol=1e-6
        )

    def test_cold_restart_without_checkpoint(self, tmp_path):
        step_fn, batch_fn, state0 = _quadratic_problem()
        tr = ResilientTrainer(
            step_fn, batch_fn,
            CheckpointManager(str(tmp_path), async_write=False),
            ckpt_every=100,  # never checkpoints before failure
            fault_injector=FaultInjector(fail_at_steps=(3,)),
        )
        state, _ = tr.run(state0, num_steps=10)
        assert tr.restarts == 1  # restarted from step 0 and completed

    def test_max_restarts_enforced(self, tmp_path):
        step_fn, batch_fn, state0 = _quadratic_problem()

        class AlwaysFail(FaultInjector):
            def check(self, step):
                if step == 2:
                    raise NodeFailure("flaky node")

        tr = ResilientTrainer(
            step_fn, batch_fn,
            CheckpointManager(str(tmp_path), async_write=False),
            ckpt_every=100,
            max_restarts=2,
            fault_injector=AlwaysFail(),
        )
        with pytest.raises(RuntimeError, match="max_restarts"):
            tr.run(state0, num_steps=10)

    def test_cold_restart_replays_from_the_initial_state(self, tmp_path):
        """The port restarts a run that failed before its first checkpoint
        from the state it was given, so it ends where a clean run ends."""
        step_fn, batch_fn, state0 = _quadratic_problem()
        clean, _ = ResilientTrainer(
            step_fn, batch_fn, CheckpointManager(str(tmp_path / "c"), async_write=False),
            ckpt_every=100).run(state0, num_steps=10)
        cold, _ = ResilientTrainer(
            step_fn, batch_fn, CheckpointManager(str(tmp_path / "f"), async_write=False),
            ckpt_every=100, fault_injector=FaultInjector(fail_at_steps=(3,))).run(state0, num_steps=10)
        np.testing.assert_array_equal(cold[0].numpy(), clean[0].numpy())
        assert int(cold[1].step) == 10


class TestStraggler:
    def test_flags_outlier(self):
        mon = StragglerMonitor(threshold=3.0)
        for s in range(10):
            mon.record(s, 0.10 + 0.001 * (s % 3))
        assert mon.record(10, 0.50)  # 5x median
        assert not mon.record(11, 0.101)
        assert len(mon.flagged) == 1


class TestElasticMesh:
    def test_best_shape(self):
        em = ElasticMesh()
        assert em.best_shape(8, model_parallel=4) == (2, 4)
        assert em.best_shape(7, model_parallel=4) == (7, 1)  # degrade to DP

    def test_remesh_devices(self):
        em = ElasticMesh()
        mesh = em.remesh([torch.device("cpu")], model_parallel=1)
        assert set(mesh.axis_names) == {"data", "model"}

    def test_remesh_on_survivors_and_reshard(self):
        em = ElasticMesh()
        mesh = em.remesh(["cpu"] * 7, model_parallel=4)  # one of 8 lost
        assert mesh.shape == {"data": 7, "model": 1} and mesh.size == 7
        assert all(s.stream is None for s in mesh.slots)
        state = {"w": torch.ones(2, 3), "step": 4, "m": [torch.zeros(3), None]}
        specs = {"w": (6, 0), "step": None, "m": [(2, 0), None]}
        out = em.reshard_state(state, specs, mesh)
        assert torch.equal(out["w"], state["w"]) and out["w"].device.type == "cpu"
        assert out["step"] == 4 and out["m"][1] is None
        assert tree_flatten(out)[1] == tree_flatten(state)[1]


class TestOptim:
    def test_adamw_converges(self):
        cfg = AdamWConfig(weight_decay=0.0)
        p = torch.tensor([5.0, -5.0])
        st = adamw_init(p, cfg)
        for _ in range(200):
            g = 2 * p
            p, st = adamw_update(g, st, p, cfg, 0.1)
        assert float(torch.max(torch.abs(p))) < 0.1

    def test_clip(self):
        g = {"a": torch.full((4,), 10.0)}
        clipped, norm = clip_by_global_norm(g, 1.0)
        assert float(norm) == pytest.approx(20.0)
        assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)

    def test_schedule_warmup_peak(self):
        f = linear_warmup_cosine(1.0, warmup_steps=10, total_steps=100)
        assert float(f(0)) == pytest.approx(0.0)
        assert float(f(10)) == pytest.approx(1.0, rel=1e-2)
        assert float(f(100)) < 0.2
        assert float(cosine_schedule(1.0, 10)(10)) == pytest.approx(0.1)
        assert float(constant_schedule(0.5)(7)) == 0.5

    def test_int8_compression_error_feedback(self):
        g = {"w": torch.linspace(-1, 1, 64)}
        ef = ef_init(g)
        codes, scales, ef = compress_grads_int8(g, ef)
        assert codes["w"].dtype == torch.int8
        out = decompress_grads_int8(codes, scales)
        # <1% of max-magnitude error per element at int8
        assert float(torch.max(torch.abs(out["w"] - g["w"]))) < 0.01
        # error feedback captured the residual
        assert float(global_norm(ef.residual)) > 0

    def test_int8_payload_is_quarter(self):
        g = {"w": torch.zeros(1024, dtype=torch.float32)}
        codes, scales, _ = compress_grads_int8(g)
        assert codes["w"].numel() * codes["w"].element_size() * 4 == (
            g["w"].numel() * 4
        )


def test_a_mesh_built_by_make_mesh_reshards_too():
    mesh = make_mesh((2,), ("data",), device="cpu")
    out = ElasticMesh().reshard_state({"a": torch.ones(2)}, {"a": (1,)}, mesh)
    assert out["a"].device == mesh.slot(1).device
