"""The port's fault injection and the Engine's fault hooks on the CPU,
held against the reference's (``tests/test_faults.py``, all but its mesh
class).

Every Engine scenario runs twice on lenet5 plans carrying the same
params: once through the reference's Engine, once through the port's,
and the two must agree on what happened — each request's outcome (logits
or the error class), the retries, the demotion record (rungs left and
why) and the rung serving at the end. Both ladders are the port's two
rungs, ``fused -> per_layer``: the reference plan is compiled with
``backend="ref"``, which leaves its ladder no third rung.

Tolerances: where the reference's own test asks for bit-exact logits,
the port's answer is held bit for bit against the port plan's direct
call; the two packages' logits against each other at the fp32
tolerance, rtol 1e-4 / atol 1e-4 (XLA and PyTorch sum in other orders).
The NaN -> integer-code pin is exact.
"""
import pytest

torch = pytest.importorskip("torch")

# One intra-op thread: the suite runs in parallel workers, and idle
# OpenMP threads would spin on cores that timing tests elsewhere use.
torch.set_num_threads(1)

import dataclasses  # noqa: E402
import random  # noqa: E402
import time  # noqa: E402
import types  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.dhm import compiler as jcompiler  # noqa: E402
from repro.core.dhm import engine as jengine  # noqa: E402
from repro.core.dhm import faults as jfaults  # noqa: E402
from repro.core.quant.fixed_point import FixedPointSpec as JSpec  # noqa: E402
from repro.core.quant.fixed_point import quantize_fixed as jquantize_fixed  # noqa: E402
from repro.kernels.stream_conv.epilogue import quantize_stream as jquantize_stream  # noqa: E402
from repro.models.cnn import ALL_TOPOLOGIES as JAX_TOPOLOGIES  # noqa: E402
from repro.models.cnn import init_cnn as jax_init_cnn  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.dhm import compiler as tcompiler  # noqa: E402
from repro_torch.core.dhm import engine as tengine  # noqa: E402
from repro_torch.core.dhm import faults as tfaults  # noqa: E402
from repro_torch.core.dhm.pipeline import (  # noqa: E402
    CollectiveTimeout,
    Watch,
    call_with_timeout,
    join_watchdogs,
    live_watchdogs,
)
from repro_torch.core.quant.fixed_point import FixedPointSpec as TSpec  # noqa: E402
from repro_torch.core.quant.fixed_point import quantize_fixed as tquantize_fixed  # noqa: E402
from repro_torch.kernels.stream_conv.epilogue import quantize_stream as tquantize_stream  # noqa: E402
from repro_torch.models.cnn import ALL_TOPOLOGIES as TORCH_TOPOLOGIES  # noqa: E402

NAME = "lenet5"
H, W, C = 28, 28, 1
TOL = dict(rtol=1e-4, atol=1e-4)
INT_HEAD = dict(act_bits=8, pow2_weights=True, int8_compute=True, per_layer_bits=(8, 8))


@pytest.fixture(scope="module")
def np_params():
    params = jax_init_cnn(jax.random.PRNGKey(0), JAX_TOPOLOGIES[NAME])
    return jax.tree_util.tree_map(np.asarray, params)


def _pkg(which, np_params, **quant):
    """One package's view of the scenario: its Engine, its fault specs,
    its lenet5 plan on ``np_params``, and how to read logits as numpy."""
    if which == "jax":
        plan = jcompiler.compile_dhm(
            JAX_TOPOLOGIES[NAME], jax.tree_util.tree_map(jnp.asarray, np_params),
            quant=jcompiler.QuantSpec(**quant), backend="ref",
        )
        ns = dict(vars(jfaults), Engine=jengine.Engine, errors=jengine, plan=plan,
                  direct=lambda x: np.asarray(plan(jnp.asarray(x))),
                  numpy=np.asarray, QuantSpec=jcompiler.QuantSpec,
                  PlanCheckError=jcompiler.PlanCheckError, check_plan=jcompiler.check_plan)
    else:
        plan = tcompiler.compile_dhm(
            TORCH_TOPOLOGIES[NAME], params_from_numpy(np_params, "cpu"),
            quant=tcompiler.QuantSpec(**quant), device="cpu",
        )
        ns = dict(vars(tfaults), Engine=tengine.Engine, errors=tengine, plan=plan,
                  direct=lambda x: plan(x).numpy(), numpy=lambda t: t.numpy(),
                  QuantSpec=tcompiler.QuantSpec, PlanCheckError=tcompiler.PlanCheckError,
                  check_plan=tcompiler.check_plan)
    return types.SimpleNamespace(**ns)


@pytest.fixture(scope="module")
def pkgs(np_params):
    return {which: _pkg(which, np_params) for which in ("jax", "torch")}


def _frames(n, seed=1):
    return np.random.default_rng(seed).normal(size=(n, H, W, C)).astype(np.float32)


def _engine(P, **kw):
    kw.setdefault("microbatch", 4)
    kw.setdefault("retry_backoff_s", 1e-4)
    return P.Engine(P.plan, **kw)


def _outcome(P, req):
    """(logits as numpy or None, error class name or None) of a request."""
    try:
        return P.numpy(req.result(timeout=60)), None
    except P.errors.RequestError as e:
        return None, type(e).__name__


def _record(eng):
    st = eng.stats()
    return dict(
        retries=st.n_retries, demotions=[d["rung"] for d in eng.demotions], rung=eng.rung,
        n_ok=st.n_ok, n_failed=st.n_failed, n_invalid=st.n_invalid, n_shed=st.n_shed,
        n_rejected=st.n_rejected, n_deadline=st.n_deadline_exceeded,
    )


def _both(pkgs, scenario):
    """Run ``scenario(P)`` -> (record, [(outcome, frames)...]) on both
    packages; the records must be equal and the logits close."""
    got = {which: scenario(P) for which, P in pkgs.items()}
    (rec_j, outs_j), (rec_t, outs_t) = got["jax"], got["torch"]
    assert rec_t == rec_j
    assert len(outs_t) == len(outs_j)
    for (lj, ej), (lt, et) in zip(outs_j, outs_t):
        assert et == ej
        if lj is not None:
            np.testing.assert_allclose(lt, lj, **TOL)
    return rec_t, outs_t


# ---------------------------------------------------------------------------
# The fault plan itself: the same firing sequence as the reference's.


def _fire_sequence(mod, faults, seed, events):
    fp = mod.FaultPlan(faults, seed=seed)
    out = []
    for kind, rung, tenant in events:
        if kind == "flush":
            out.append(("flush", fp.on_flush(tenant=tenant)))
        else:
            e = fp.dispatch_effects(rung=rung, tenant=tenant)
            out.append(("dispatch", e.stall_s, type(e.exc).__name__ if e.exc else None,
                        str(e.exc) if e.exc else None, e.corrupt_stage, e.clean))
    counts = (fp.n_dispatch_events, fp.n_flush_events,
              {t: fp.n_dispatch_events_for(t) for t in ("A", "B", None)})
    return out, counts


def _specs(mod, seed):
    rng = random.Random(seed)
    out = []
    for _ in range(rng.randint(1, 5)):
        kind = rng.choice(("DelayedFlush", "DispatchError", "StalledDispatch",
                           "NaNActivation", "DeviceLoss"))
        kw = dict(at=rng.randint(0, 4), times=rng.choice((None, 1, 2, 3)),
                  rung=rng.choice((None, "fused", "per_layer")),
                  tenant=rng.choice((None, "A", "B")))
        if rng.random() < 0.3:
            kw["prob"] = rng.choice((0.25, 0.5, 0.9))
        if kind == "DelayedFlush":
            kw["delay_s"] = rng.choice((0.01, 0.05))
        elif kind == "StalledDispatch":
            kw["stall_s"] = rng.choice((0.1, 0.5))
        elif kind == "NaNActivation":
            kw["stage"] = rng.randint(0, 1)
        out.append(getattr(mod, kind)(**kw))
    return out


class TestFaultPlan:
    @pytest.mark.parametrize("seed", range(6))
    def test_fires_on_the_reference_events(self, seed):
        """Random fault sets, seeds and an interleaving of three tenant
        streams over both rungs: every hook returns what the reference's
        returns, and the event counters agree."""
        rng = random.Random(100 + seed)
        events = [(rng.choice(("flush", "dispatch", "dispatch")),
                   rng.choice(("fused", "per_layer", None)),
                   rng.choice(("A", "B", None))) for _ in range(40)]
        want = _fire_sequence(jfaults, _specs(jfaults, seed), seed, events)
        got = _fire_sequence(tfaults, _specs(tfaults, seed), seed, events)
        assert got == want

    def test_trigger_window(self):
        fp = tfaults.FaultPlan([tfaults.DispatchError(at=1, times=2)])
        effs = [fp.dispatch_effects(rung="fused") for _ in range(5)]
        assert [e.exc is not None for e in effs] == [False, True, True, False, False]

    def test_forever_window(self):
        fp = tfaults.FaultPlan([tfaults.DispatchError(at=0, times=None)])
        assert all(fp.dispatch_effects(rung="x").exc is not None for _ in range(4))

    def test_rung_filter(self):
        fp = tfaults.FaultPlan([tfaults.DeviceLoss(at=0, times=None, rung="fused")])
        assert fp.dispatch_effects(rung="fused").exc is not None
        assert fp.dispatch_effects(rung="per_layer").clean

    def test_seeded_probability_is_deterministic(self):
        def run(mod):
            fp = mod.FaultPlan([mod.DispatchError(prob=0.5)], seed=7)
            return [fp.dispatch_effects(rung=None).exc is not None for _ in range(32)]

        fires = run(tfaults)
        assert fires == run(tfaults) == run(jfaults)
        assert any(fires) and not all(fires)

    def test_flush_delay_counter(self):
        fp = tfaults.FaultPlan([tfaults.DelayedFlush(at=1, delay_s=0.25)])
        assert [fp.on_flush() for _ in range(3)] == [0.0, 0.25, 0.0]

    def test_non_fault_spec_rejected(self):
        with pytest.raises(TypeError, match="Fault specs"):
            tfaults.FaultPlan(["boom"])

    def test_tenant_scoped_window_is_deterministic_under_interleaving(self):
        fp = tfaults.FaultPlan([tfaults.DispatchError(at=1, times=1, tenant="A")])
        fired = []
        for _ in range(3):
            fired.append(fp.dispatch_effects(rung="fused", tenant="A"))
            assert fp.dispatch_effects(rung="fused", tenant="B").clean
            assert fp.dispatch_effects(rung="fused", tenant=None).clean
        assert [e.exc is not None for e in fired] == [False, True, False]
        assert [fp.n_dispatch_events_for(t) for t in ("A", "B", None)] == [3, 3, 3]


class TestWatchdog:
    def test_timeout_raises_instead_of_hanging(self):
        with pytest.raises(CollectiveTimeout, match="did not complete"):
            call_with_timeout(lambda: time.sleep(0.5), timeout_s=0.05, what="test sleep")
        assert join_watchdogs(5.0) == 0

    def test_value_and_error_pass_through(self):
        assert call_with_timeout(lambda: 42, timeout_s=1.0) == 42
        with pytest.raises(KeyError):
            call_with_timeout(lambda: (_ for _ in ()).throw(KeyError("k")), timeout_s=1.0)

    def test_a_given_up_call_never_claims_its_launch(self):
        """The worker stalls on the watch; the watchdog gives up, which
        wakes the stall at once, and the worker's claim then fails: it
        launches nothing after its caller moved on."""
        watch, claimed = Watch(), []

        def worker():
            watch.sleep(30.0)
            claimed.append(watch.claim())

        t0 = time.perf_counter()
        with pytest.raises(CollectiveTimeout):
            call_with_timeout(worker, timeout_s=0.05, watch=watch)
        assert join_watchdogs(5.0) == 0 and live_watchdogs() == 0
        assert time.perf_counter() - t0 < 5.0  # the 30 s stall ended at the give-up
        assert claimed == [False] and not watch.claim()


# ---------------------------------------------------------------------------
# Plan self-check (the health probe).


class TestPlanCheck:
    def test_healthy_plan_passes(self, pkgs):
        P = pkgs["torch"]
        P.check_plan(P.plan)
        P.plan.self_check()

    def test_nonfinite_params_fail(self, pkgs):
        for P, nan in ((pkgs["jax"], lambda w: w.at[0, 0, 0, 0].set(jnp.nan)),
                       (pkgs["torch"], lambda w: w.clone().index_put_(
                           (torch.tensor(0),) * 4, torch.tensor(float("nan"))))):
            bad_conv = list(P.plan.conv_params)
            bad_conv[0] = {"w": nan(bad_conv[0]["w"]), "b": bad_conv[0]["b"]}
            bad = dataclasses.replace(P.plan, conv_params=tuple(bad_conv))
            with pytest.raises(P.PlanCheckError, match="non-finite") as err:
                P.check_plan(bad)
            assert err.value.invariants == ("V301",)

    def test_inconsistent_io_fails(self, pkgs):
        ids = {}
        for which, P in pkgs.items():
            st0 = P.plan.stages[0]
            bad_io = dataclasses.replace(st0.io, out_shape=(1, 1, st0.io.out_shape[-1]))
            bad = dataclasses.replace(
                P.plan, stages=(dataclasses.replace(st0, io=bad_io),) + P.plan.stages[1:])
            with pytest.raises(P.PlanCheckError) as err:
                P.check_plan(bad)
            ids[which] = set(err.value.invariants)
        assert ids["torch"] == ids["jax"] == {"V303", "V304"}

    def test_engine_refuses_unhealthy_plan(self, pkgs):
        P = pkgs["torch"]
        bad_conv = list(P.plan.conv_params)
        bad_conv[0] = {"w": torch.full_like(bad_conv[0]["w"], float("inf")),
                       "b": bad_conv[0]["b"]}
        bad = dataclasses.replace(P.plan, conv_params=tuple(bad_conv))
        with pytest.raises(P.PlanCheckError):
            P.Engine(bad, microbatch=4)


# ---------------------------------------------------------------------------
# Fault classes, one by one, in both packages.


class TestTransientDispatchError:
    def test_retry_heals_bit_exact(self, pkgs):
        def scenario(P):
            eng = _engine(P, fault_plan=P.FaultPlan([P.DispatchError(at=0, times=1)]))
            x = _frames(4)
            out = _outcome(P, eng.submit(x))
            np.testing.assert_array_equal(out[0], P.direct(x))
            return _record(eng), [out]

        rec, _ = _both(pkgs, scenario)
        assert rec["retries"] == 1 and rec["demotions"] == [] and rec["rung"] == "fused"

    def test_persistent_error_demotes_and_serves(self, pkgs):
        def scenario(P):
            eng = _engine(P, fault_plan=P.FaultPlan([P.DispatchError(at=0, times=3, rung="fused")]),
                          max_retries=2)
            x = _frames(4)
            out = _outcome(P, eng.submit(x))
            np.testing.assert_allclose(out[0], P.direct(x), **TOL)
            return _record(eng), [out]

        rec, _ = _both(pkgs, scenario)
        assert rec["retries"] == 2 and rec["demotions"] == ["fused"]
        assert rec["rung"] == "per_layer"


class TestLadder:
    def test_demotion_order_and_exhaustion(self, pkgs):
        def scenario(P):
            eng = _engine(P, fault_plan=P.FaultPlan([P.DispatchError(at=0, times=2)]),
                          max_retries=0)
            req = eng.submit(_frames(4))
            eng.flush()
            failed = _outcome(P, req)
            x = _frames(4, seed=2)
            served = _outcome(P, eng.submit(x))
            np.testing.assert_allclose(served[0], P.direct(x), **TOL)
            assert "demotions" in eng.stats().summary()
            return _record(eng), [failed, served]

        rec, outs = _both(pkgs, scenario)
        assert outs[0][1] == "BatchFailed"
        assert rec["demotions"] == ["fused", "per_layer"] and rec["rung"] == "per_layer"
        assert rec["n_failed"] == 1 and rec["n_ok"] == 1

    def test_allow_degraded_false_pins_the_rung(self, pkgs):
        def scenario(P):
            eng = _engine(P, fault_plan=P.FaultPlan([P.DispatchError(at=0, times=None)]),
                          max_retries=0, allow_degraded=False)
            req = eng.submit(_frames(4))
            eng.flush()  # must not raise: the failure is per-request
            return _record(eng), [_outcome(P, req)]

        rec, outs = _both(pkgs, scenario)
        assert outs[0][1] == "BatchFailed" and rec["rung"] == "fused"


class TestStalledDispatch:
    def test_timeout_demotes_instead_of_hanging(self, pkgs):
        def scenario(P):
            eng = _engine(P, fault_plan=P.FaultPlan(
                [P.StalledDispatch(at=0, times=1, stall_s=5.0, rung="fused")]),
                dispatch_timeout_s=0.2)
            x = _frames(4)
            out = _outcome(P, eng.submit(x))
            np.testing.assert_allclose(out[0], P.direct(x), **TOL)
            assert "did not complete" in eng.demotions[0]["reason"]
            return _record(eng), [out]

        rec, _ = _both(pkgs, scenario)
        assert rec["demotions"] == ["fused"] and rec["retries"] == 0

    def test_abandoned_attempt_launches_nothing(self, pkgs):
        """The port's stalled attempt wakes when its watchdog gives up and
        never calls the rung it was dispatched on (the reference's sleeps
        on and runs it, its result discarded)."""
        P = pkgs["torch"]
        eng = _engine(P, fault_plan=P.FaultPlan(
            [P.StalledDispatch(at=0, times=1, stall_s=30.0, rung="fused")]),
            dispatch_timeout_s=0.2)
        calls, fused = [], eng._fwd
        eng._fwd = lambda xb: calls.append(1) or fused(xb)
        t0 = time.perf_counter()
        x = _frames(4)
        np.testing.assert_allclose(eng.infer(x).numpy(), P.direct(x), **TOL)
        assert join_watchdogs(5.0) == 0
        assert time.perf_counter() - t0 < 10.0
        assert calls == [] and eng.rung == "per_layer"

    def test_abandoned_attempt_keeps_its_own_watch_after_a_demotion(self, pkgs, monkeypatch):
        """The stalled worker wakes only after the engine has demoted
        (``warmup=False``: no probe between) and the next attempt has
        launched: it must still see its own given-up watch and rung, and
        launch nothing beside the surviving attempt."""
        P = pkgs["torch"]
        eng = _engine(P, warmup=False, fault_plan=P.FaultPlan(
            [P.StalledDispatch(at=0, times=1, stall_s=30.0, rung="fused")]),
            dispatch_timeout_s=0.2)
        calls, served = [], tengine.threading.Event()
        fused = eng._fwd
        eng._fwd = lambda xb: calls.append("fused") or fused(xb)
        unfused = eng._ladder[1][1]

        def counting_unfused():
            fwd = unfused()

            def _fwd(xb):
                calls.append("per_layer")
                out = fwd(xb)
                served.set()
                return out

            return _fwd

        eng._ladder[1] = ("per_layer", counting_unfused)
        sleep = Watch.sleep

        def late_wake(watch, seconds):
            sleep(watch, seconds)
            served.wait(5.0)

        monkeypatch.setattr(Watch, "sleep", late_wake)
        x = _frames(4)
        np.testing.assert_allclose(eng.infer(x).numpy(), P.direct(x), **TOL)
        assert join_watchdogs(10.0) == 0
        assert calls == ["per_layer"] and eng.rung == "per_layer"


class TestNaNActivation:
    def test_transient_corruption_retries_bit_exact(self, pkgs):
        def scenario(P):
            eng = _engine(P, fault_plan=P.FaultPlan([P.NaNActivation(at=0, times=1, stage=0)]))
            x = _frames(4)
            out = _outcome(P, eng.submit(x))
            np.testing.assert_array_equal(out[0], P.direct(x))
            return _record(eng), [out]

        rec, _ = _both(pkgs, scenario)
        assert rec["retries"] == 1 and rec["demotions"] == []

    def test_persistent_corruption_demotes(self, pkgs):
        def scenario(P):
            eng = _engine(P, fault_plan=P.FaultPlan(
                [P.NaNActivation(at=0, times=None, stage=0, rung="fused")]), max_retries=1)
            x = _frames(4)
            out = _outcome(P, eng.submit(x))
            np.testing.assert_allclose(out[0], P.direct(x), **TOL)
            assert "non-finite" in eng.demotions[0]["reason"]
            return _record(eng), [out]

        rec, _ = _both(pkgs, scenario)
        assert rec["demotions"] == ["fused"] and rec["rung"] == "per_layer"


class TestDeviceLoss:
    def test_device_loss_demotes_without_retry(self, pkgs):
        def scenario(P):
            eng = _engine(P, fault_plan=P.FaultPlan([P.DeviceLoss(at=0, times=1)]))
            x = _frames(4)
            out = _outcome(P, eng.submit(x))
            np.testing.assert_allclose(out[0], P.direct(x), **TOL)
            assert "device loss" in eng.demotions[0]["reason"]
            return _record(eng), [out]

        rec, _ = _both(pkgs, scenario)
        assert rec["demotions"] == ["fused"] and rec["retries"] == 0


class TestBadFrames:
    def test_gate_validation_fails_alone(self, pkgs):
        def scenario(P):
            eng = _engine(P)
            bad = _frames(2)
            bad[0, 0, 0, 0] = np.nan
            good_req = eng.submit(_frames(2))
            bad_req = eng.submit(bad)
            eng.flush()
            return _record(eng), [_outcome(P, good_req), _outcome(P, bad_req)]

        rec, outs = _both(pkgs, scenario)
        assert outs[1][1] == "InvalidRequest" and rec["n_invalid"] == 1 and rec["n_ok"] == 1

    def test_wrong_dtype_fails_alone(self, pkgs):
        def scenario(P):
            eng = _engine(P)
            req = eng.submit(np.zeros((1, H, W, C), np.int32))
            return _record(eng), [_outcome(P, req)]

        _, outs = _both(pkgs, scenario)
        assert outs[0][1] == "InvalidRequest"

    def test_poisoned_batch_is_isolated(self, pkgs):
        def scenario(P):
            eng = _engine(P, validate=False)
            bad = _frames(2)
            bad[1, 3, 3, 0] = np.nan
            good_req = eng.submit(_frames(2))
            bad_req = eng.submit(bad)
            eng.flush()
            return _record(eng), [_outcome(P, good_req), _outcome(P, bad_req)]

        rec, outs = _both(pkgs, scenario)
        assert outs[1][1] == "InvalidRequest"
        assert rec["n_invalid"] == 1 and rec["n_ok"] == 1 and rec["demotions"] == []


class TestDelayedFlushDeadlines:
    def test_stalled_flush_expires_deadlines_only(self, pkgs):
        def scenario(P):
            eng = _engine(P, fault_plan=P.FaultPlan([P.DelayedFlush(at=0, times=1, delay_s=0.05)]))
            slo = eng.submit(_frames(2), deadline_ms=5.0)
            free = eng.submit(_frames(2, seed=3))
            eng.flush()
            return _record(eng), [_outcome(P, slo), _outcome(P, free)]

        rec, outs = _both(pkgs, scenario)
        assert outs[0][1] == "DeadlineExceeded"
        assert rec["n_deadline"] == 1 and rec["n_ok"] == 1


class TestAdmissionUnderChaos:
    def test_reject_policy(self, pkgs):
        def scenario(P):
            eng = _engine(P, max_queue=1, admission="reject")
            r1 = eng.submit(_frames(1))
            r2 = eng.submit(_frames(1))
            outs = [_outcome(P, r2), _outcome(P, r1)]
            return _record(eng), outs

        rec, outs = _both(pkgs, scenario)
        assert outs[0][1] == "Rejected" and rec["n_rejected"] == 1 and rec["n_ok"] == 1

    def test_shed_oldest_policy(self, pkgs):
        def scenario(P):
            eng = _engine(P, max_queue=1, admission="shed_oldest")
            r1 = eng.submit(_frames(1))
            r2 = eng.submit(_frames(1, seed=4))
            outs = [_outcome(P, r1), _outcome(P, r2)]
            return _record(eng), outs

        rec, outs = _both(pkgs, scenario)
        assert outs[0][1] == "Shed" and rec["n_shed"] == 1 and rec["n_ok"] == 1


# ---------------------------------------------------------------------------
# NaN features into the integer head: a reference failure the port keeps.


def test_nan_gives_code_zero_as_in_the_reference():
    """Float -> int of NaN is undefined in C++ (INT_MIN on an x86 CPU, 0 on
    the card); the reference's conversion gives 0, and so does the port,
    on every device. Inf saturates to the grid's ends in both."""
    vals = np.array([np.nan, -np.nan, np.inf, -np.inf, 1.0, -0.30, 7.9], np.float32)
    want = np.asarray(jquantize_fixed(jnp.asarray(vals), JSpec(bits=8, frac_bits=4)))
    got = tquantize_fixed(torch.from_numpy(vals), TSpec(bits=8, frac_bits=4)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == got[1] == 0
    want8 = np.asarray(jquantize_stream(jnp.asarray(vals), 8))
    got8 = tquantize_stream(torch.from_numpy(vals), 8)
    assert got8.dtype == torch.int8
    np.testing.assert_array_equal(got8.numpy().astype(np.int32), want8.astype(np.int32))


def test_nan_features_into_the_integer_head_serve_the_reference_logits(np_params):
    """NaN features quantize to code 0 at the integer pow2 head, which
    serves finite logits: ``NaNActivation`` on such a plan is never
    detected, in the reference as in the port. Both serve the same
    corrupted answer, with no retry."""
    pkgs8 = {which: _pkg(which, np_params, **INT_HEAD) for which in ("jax", "torch")}
    # One micro-batch of features: the engine's head call below reuses
    # the reference head's compiled shape.
    feat = (4,) + tuple(TORCH_TOPOLOGIES[NAME].feature_shape())
    want = np.asarray(pkgs8["jax"].plan.head_fn(jnp.full(feat, jnp.nan)))
    got = pkgs8["torch"].plan.head_fn(torch.full(feat, float("nan"))).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)

    def scenario(P):
        eng = _engine(P, fault_plan=P.FaultPlan([P.NaNActivation(at=0, times=1, stage=0)]))
        x = _frames(4)
        out = _outcome(P, eng.submit(x))
        assert not np.array_equal(out[0], P.direct(x))  # the corrupted answer is served
        return _record(eng), [out]

    rec, outs = _both(pkgs8, scenario)
    assert rec["retries"] == 0 and rec["demotions"] == [] and rec["n_ok"] == 1
    np.testing.assert_array_equal(outs[0][0], got)
