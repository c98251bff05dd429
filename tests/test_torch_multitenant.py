"""The port's multi-tenant Router on the CPU: the scenarios of the
reference's ``tests/test_multitenant.py`` — routing, bulkhead isolation
under tenant-scoped chaos, the circuit breaker's lifecycle, verified hot
swap and rollback, weighted-fair scheduling under concurrent submitters
— run on the port's Router, and the per-tenant logits held against the
reference Router's on the same inputs.

Plans: lenet5 at the reference init's params (seeds 0 and 7), carried
across as numpy. Tolerances: where the reference's test asks for
bit-exact logits, the port's Router answer is held bit for bit against
the port plan's direct call; against the reference Router's logits at
the fp32 tolerance, rtol 1e-4 / atol 1e-4. Every wait carries its own
time limit (``result(timeout=...)``, the Router's ``join_timeout_s``).
"""
import pytest

torch = pytest.importorskip("torch")

# One intra-op thread: the suite runs in parallel workers, and idle
# OpenMP threads would spin on cores that timing tests elsewhere use.
torch.set_num_threads(1)

import dataclasses  # noqa: E402
import functools  # noqa: E402
import gc  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.dhm import compiler as jcompiler  # noqa: E402
from repro.core.dhm import multitenant as jmultitenant  # noqa: E402
from repro.models.cnn import ALL_TOPOLOGIES as JAX_TOPOLOGIES  # noqa: E402
from repro.models.cnn import init_cnn as jax_init_cnn  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.dhm import (  # noqa: E402
    BatchFailed,
    CircuitBreaker,
    CircuitOpen,
    DeviceLoss,
    DispatchError,
    FaultPlan,
    NaNActivation,
    QuantSpec,
    Rejected,
    RequestError,
    Router,
    StalledDispatch,
    SwapRejected,
    UnknownTenant,
    compile_dhm,
)
from repro_torch.core.dhm.pipeline import join_watchdogs  # noqa: E402
from repro_torch.models.cnn import ALL_TOPOLOGIES, init_cnn  # noqa: E402

TOPO = ALL_TOPOLOGIES["lenet5"]
TOL = dict(rtol=1e-4, atol=1e-4)
JOIN_S = 30.0


@functools.lru_cache(maxsize=None)
def _np_params(name, seed):
    params = jax_init_cnn(jax.random.PRNGKey(seed), JAX_TOPOLOGIES[name])
    return jax.tree_util.tree_map(np.asarray, params)


def _plan(name="lenet5", seed=0):
    return compile_dhm(ALL_TOPOLOGIES[name], params_from_numpy(_np_params(name, seed), "cpu"),
                       quant=QuantSpec(), device="cpu")


@pytest.fixture(scope="module")
def plan():
    return _plan(seed=0)


@pytest.fixture(scope="module")
def plan2():
    """Same topology, different params — a compatible swap target whose
    logits are distinguishable from ``plan``'s."""
    return _plan(seed=7)


@pytest.fixture(scope="module")
def plan_wide():
    """A different serving surface (frame geometry) — an incompatible
    swap target; no reference counterpart, so its params are the port's
    own init's)."""
    topo = ALL_TOPOLOGIES["cifar10"]
    return compile_dhm(topo, init_cnn(torch.Generator().manual_seed(0), topo, device="cpu"),
                       quant=QuantSpec(), device="cpu")


def _frames(n, seed=1):
    h, w = TOPO.input_shape
    return np.random.default_rng(seed).normal(size=(n, h, w, TOPO.input_channels)).astype(np.float32)


def _router(**kw):
    kw.setdefault("microbatch", 4)
    kw.setdefault("retry_backoff_s", 1e-4)
    kw.setdefault("scheduler_interval_ms", 1.0)
    kw.setdefault("breaker_reset_s", 0.1)
    kw.setdefault("join_timeout_s", JOIN_S)
    return Router(**kw)


def _exact(got, want):
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# ---------------------------------------------------------------------------
# The reference Router on the same inputs.


def test_tenant_logits_equal_the_reference_routers():
    """Two tenants, a hot swap with requests in flight and a rollback,
    through both Routers on the same params and frames: each request's
    logits agree at the fp32 tolerance, and each package's answers are
    its own plans' bit for bit (a request that fills whole micro-batches;
    a padded tail at the fp32 tolerance, as the reference's own tests
    hold it)."""

    def run(router_cls, compile_, to_np):
        plans = {s: compile_(s) for s in (0, 7)}
        out = []
        with router_cls(microbatch=4, retry_backoff_s=1e-4, scheduler_interval_ms=1.0,
                        join_timeout_s=JOIN_S) as r:
            r.add("A", plans[0])
            r.add("B", plans[7], weight=3.0)
            reqs = [(r.submit(t, _frames(n, seed=10 * i + n)), t, _frames(n, seed=10 * i + n))
                    for i, (t, n) in enumerate((("A", 4), ("B", 3), ("A", 1), ("B", 4)))]
            r.swap("A", plans[7])
            reqs.append((r.submit("A", _frames(4, seed=99)), "A*", _frames(4, seed=99)))
            for req, tenant, x in reqs:
                got = to_np(req.result(timeout=60))
                want = to_np(plans[7 if tenant != "A" else 0](x))
                if len(x) % 4:  # a padded tail sums in another batch shape
                    np.testing.assert_allclose(got, want, **TOL)
                else:
                    np.testing.assert_array_equal(got, want)
                out.append(got)
            r.rollback("A")
            x = _frames(4, seed=5)
            got = to_np(r.submit("A", x).result(timeout=60))
            np.testing.assert_array_equal(got, to_np(plans[0](x)))
            out.append(got)
        return out

    want = run(jmultitenant.Router,
               lambda s: jcompiler.compile_dhm(
                   JAX_TOPOLOGIES["lenet5"], jax.tree_util.tree_map(jnp.asarray, _np_params("lenet5", s))),
               np.asarray)
    got = run(Router, lambda s: _plan(seed=s), lambda t: t.numpy())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


# ---------------------------------------------------------------------------
# Routing basics.


class TestRouterBasics:
    def test_two_tenants_serve_bit_exact(self, plan, plan2):
        with _router() as r:
            r.add("A", plan)
            r.add("B", plan2)
            xa, xb = _frames(4, seed=1), _frames(4, seed=2)
            ra = r.submit("A", xa)
            rb = r.submit("B", xb)
            _exact(ra.result(timeout=60), plan(xa))
            _exact(rb.result(timeout=60), plan2(xb))
            st = r.stats()
            assert st["A"].n_ok == 1 and st["B"].n_ok == 1
            assert st["A"].n_errors == 0 and st["B"].n_errors == 0

    def test_unknown_tenant_and_duplicate_add(self, plan):
        r = _router()
        r.add("A", plan)
        with pytest.raises(UnknownTenant):
            r.submit("nope", _frames(1))
        with pytest.raises(ValueError, match="already registered"):
            r.add("A", plan)

    def test_tenants_must_not_run_their_own_flusher(self, plan):
        r = _router()
        with pytest.raises(ValueError, match="auto_flush"):
            r.add("A", plan, auto_flush=True)

    def test_remove_sheds_queued_requests(self, plan):
        r = _router()  # scheduler NOT started: requests stay queued
        r.add("A", plan)
        req = r.submit("A", _frames(2))
        r.remove("A")
        with pytest.raises(Rejected):  # Shed is a Rejected subclass
            req.result(timeout=5)
        assert "A" not in r.tenants

    def test_describe_reports_operator_view(self, plan):
        r = _router()
        r.add("A", plan, weight=2.0)
        d = r.describe()["A"]
        assert d["breaker"] == "closed"
        assert d["weight"] == 2.0
        assert d["rung"] == "fused"
        assert d["group_cost"] > 0
        assert d["rollback_available"] is False


# ---------------------------------------------------------------------------
# Bulkhead isolation under tenant-scoped chaos.


class TestIsolationUnderChaos:
    def test_faulted_tenant_blast_radius_contained(self, plan, plan2):
        """All four fault classes hammer tenant A; tenant B's error rate
        stays 0 and its steady-state p99 stays within 1.5x of its
        no-fault baseline."""
        faults = FaultPlan(
            [
                DispatchError(at=0, times=2, tenant="A"),
                StalledDispatch(at=2, times=2, stall_s=0.5, tenant="A"),
                NaNActivation(at=4, times=2, stage=0, tenant="A"),
                DeviceLoss(at=6, times=None, tenant="A"),
            ],
            seed=0,
        )
        r = _router(fault_plan=faults, max_retries=0, allow_degraded=False,
                    breaker_threshold=7, breaker_reset_s=60.0)
        r.add("A", plan, dispatch_timeout_s=0.2)
        r.add("B", plan2)
        with r:
            for i in range(3):
                r.submit("B", _frames(4, seed=90 + i)).result(timeout=60)
            r.engine("B").reset_stats()
            gc.collect()
            gc.disable()
            try:
                for i in range(60):
                    r.submit("B", _frames(4, seed=100 + i)).result(timeout=60)
            finally:
                gc.enable()
            baseline = r.engine("B").stats().rung_latency_ms["fused"]
            assert baseline["n"] == 60

            a_errors = []
            for i in range(12):
                req = r.submit("A", _frames(4, seed=200 + i))
                with pytest.raises(RequestError) as exc:
                    req.result(timeout=60)
                a_errors.append(exc.value)
                if r.breaker("A").state == "open":
                    break
            assert r.breaker("A").state == "open"
            assert r.breaker("A").n_opens == 1
            assert any(isinstance(e, BatchFailed) for e in a_errors)
            assert faults.n_dispatch_events_for("A") >= 7

            # The port's abandoned stalled attempts end when their watchdog
            # gives up: nothing of phase 2 is left running.
            assert join_watchdogs(5.0) == 0
            r.engine("B").reset_stats()
            gc.collect()
            gc.disable()
            try:
                for i in range(60):
                    req_a = r.submit("A", _frames(2, seed=300 + i))
                    with pytest.raises(CircuitOpen):
                        req_a.result(timeout=60)
                    r.submit("B", _frames(4, seed=400 + i)).result(timeout=60)
            finally:
                gc.enable()
            st_b = r.engine("B").stats()
            assert st_b.n_ok == 60
            assert st_b.n_errors == 0
            chaos = st_b.rung_latency_ms["fused"]
            tick_ms = 2 * r.scheduler_interval_ms
            assert chaos["p99_ms"] <= 1.5 * baseline["p99_ms"] + tick_ms, (
                f"tenant B p99 {chaos['p99_ms']:.2f} ms under chaos vs "
                f"baseline {baseline['p99_ms']:.2f} ms — bulkhead leaked"
            )
            assert r.engine("B").demotions == []
            assert r.engine("B").rung == "fused"

    def test_tenant_scoped_faults_never_touch_other_tenants(self, plan):
        faults = FaultPlan([DispatchError(at=0, times=None, tenant="A")], seed=0)
        with _router(fault_plan=faults, max_retries=0, allow_degraded=False) as r:
            r.add("A", plan)
            r.add("B", plan)
            ok_b = 0
            for i in range(5):
                with pytest.raises(RequestError):
                    r.submit("A", _frames(2, seed=i)).result(timeout=60)
                r.submit("B", _frames(2, seed=i)).result(timeout=60)
                ok_b += 1
            assert ok_b == 5
            assert r.engine("B").stats().n_errors == 0
            assert faults.n_dispatch_events_for("B") >= 5


# ---------------------------------------------------------------------------
# Circuit breaker lifecycle.


class TestCircuitBreaker:
    def test_state_machine_unit(self):
        br = CircuitBreaker(threshold=2, reset_s=0.0)
        assert br.state == "closed"
        assert br.record_failure() is False
        assert br.record_failure() is True
        assert br.state == "open"
        assert br.n_opens == 1
        assert br.due_for_probe
        br.close()
        assert br.state == "closed"
        assert br.consecutive_failures == 0
        br.record_failure()
        br.record_success()
        assert br.consecutive_failures == 0

    def test_open_breaker_fails_fast_and_sheds_queue(self, plan):
        faults = FaultPlan([DispatchError(at=0, times=None, tenant="A")], seed=0)
        with _router(fault_plan=faults, max_retries=0, allow_degraded=False,
                     breaker_threshold=2, breaker_reset_s=60.0) as r:
            r.add("A", plan)
            outcomes = []
            for i in range(8):
                req = r.submit("A", _frames(2, seed=i))
                try:
                    req.result(timeout=60)
                    outcomes.append("ok")
                except CircuitOpen:
                    outcomes.append("circuit_open")
                except RequestError:
                    outcomes.append("failed")
            assert "ok" not in outcomes
            assert "circuit_open" in outcomes
            assert r.breaker("A").state == "open"
            t0 = time.perf_counter()
            with pytest.raises(CircuitOpen):
                r.submit("A", _frames(2)).result(timeout=60)
            assert time.perf_counter() - t0 < 0.5

    def test_half_open_probe_closes_after_fault_clears(self, plan):
        faults = FaultPlan([DispatchError(at=0, times=3, tenant="A")], seed=0)
        with _router(fault_plan=faults, max_retries=0, allow_degraded=False,
                     breaker_threshold=2, breaker_reset_s=0.05) as r:
            r.add("A", plan)
            for i in range(4):
                try:
                    r.submit("A", _frames(2, seed=i)).result(timeout=60)
                except RequestError:
                    pass
            deadline = time.monotonic() + 30.0
            while r.breaker("A").state != "closed" and time.monotonic() < deadline:
                time.sleep(0.02)
            br = r.breaker("A")
            assert br.state == "closed", f"breaker stuck {br.state}"
            assert br.n_opens >= 1
            assert br.n_probes >= 1
            x = _frames(4, seed=99)
            _exact(r.submit("A", x).result(timeout=60), plan(x))


# ---------------------------------------------------------------------------
# Verified hot plan swap.


class TestHotSwap:
    def test_swap_drops_nothing_and_is_bit_exact(self, plan, plan2):
        with _router() as r:
            r.add("T", plan)
            xs = [_frames(4, seed=10 + i) for i in range(6)]
            pre = [r.submit("T", x) for x in xs]
            r.swap("T", plan2)
            for req, x in zip(pre, xs):
                _exact(req.result(timeout=60), plan(x))
            x = _frames(4, seed=42)
            _exact(r.submit("T", x).result(timeout=60), plan2(x))
            d = r.describe()["T"]
            assert d["n_swaps"] == 1
            assert d["rollback_available"] is True

    def test_swap_to_unverifiable_plan_rejected(self, plan):
        bad_conv = list(plan.conv_params)
        w = bad_conv[0]["w"].clone()
        w[0, 0, 0, 0] = float("nan")
        bad_conv[0] = {"w": w, "b": bad_conv[0]["b"]}
        bad = dataclasses.replace(plan, conv_params=tuple(bad_conv))
        with _router() as r:
            r.add("T", plan)
            with pytest.raises(SwapRejected) as exc:
                r.swap("T", bad)
            assert "V301" in exc.value.invariants
            x = _frames(4, seed=5)
            _exact(r.submit("T", x).result(timeout=60), plan(x))
            assert r.describe()["T"]["n_swaps"] == 0

    def test_swap_to_incompatible_surface_rejected(self, plan, plan_wide):
        with _router() as r:
            r.add("T", plan)
            with pytest.raises(SwapRejected, match="serving surface"):
                r.swap("T", plan_wide)
            x = _frames(4, seed=6)
            _exact(r.submit("T", x).result(timeout=60), plan(x))

    def test_rollback_restores_previous_plan(self, plan, plan2):
        with _router() as r:
            r.add("T", plan)
            r.swap("T", plan2)
            r.rollback("T")
            x = _frames(4, seed=8)
            _exact(r.submit("T", x).result(timeout=60), plan(x))
            assert r.describe()["T"]["rollback_available"] is False
            with pytest.raises(RuntimeError, match="no previous plan"):
                r.rollback("T")


# ---------------------------------------------------------------------------
# Weighted-fair scheduling + the concurrent-submitter property test.


class TestFairnessAndConcurrency:
    N_TENANTS = 2
    N_THREADS = 4
    PER_THREAD = 12

    @pytest.mark.parametrize("admission", ["block", "reject", "shed_oldest"])
    def test_concurrent_submitters_conserve_and_share(self, plan, admission):
        """T threads x N tenants against a small queue under every
        admission policy: every submit resolves to exactly one terminal
        state (conservation, no deadlock), and no tenant's completed
        share falls below 1/(2N) under equal offered load."""
        tenants = [f"t{i}" for i in range(self.N_TENANTS)]
        r = _router(admission=admission, max_queue=4, microbatch=2)
        for name in tenants:
            r.add(name, plan)
        results = []
        res_lock = threading.Lock()

        def submitter(tid):
            for i in range(self.PER_THREAD):
                tenant = tenants[(tid + i) % self.N_TENANTS]
                req = r.submit(tenant, _frames(1, seed=tid * 100 + i))
                try:
                    out = req.result(timeout=120)
                    assert out.shape[-1] == 10
                    outcome = "ok"
                except RequestError:
                    outcome = "error"
                assert req.done
                assert (req.ok, req.error is not None) in ((True, False), (False, True))
                with res_lock:
                    results.append((tenant, outcome))

        with r:
            threads = [threading.Thread(target=submitter, args=(tid,))
                       for tid in range(self.N_THREADS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=180.0)
            assert not any(t.is_alive() for t in threads), "submitter deadlocked"
        assert len(results) == self.N_THREADS * self.PER_THREAD
        completed = [t for (t, o) in results if o == "ok"]
        assert completed, f"no request completed under {admission}"
        share_floor = len(completed) / (2 * self.N_TENANTS)
        for name in tenants:
            n = sum(1 for t in completed if t == name)
            assert n >= share_floor, (
                f"tenant {name} completed {n}/{len(completed)} under "
                f"{admission} — below the 1/(2N) fairness floor"
            )

    def test_weight_biases_service_share(self, plan):
        r = _router(max_queue=0, microbatch=2)
        r.add("heavy", plan, weight=2.0)
        r.add("light", plan, weight=1.0)
        reqs = []
        for i in range(10):
            reqs.append(r.submit("heavy", _frames(2, seed=i)))
            reqs.append(r.submit("light", _frames(2, seed=50 + i)))
        with r:
            for req in reqs:
                req.result(timeout=120)
        st = r.stats()
        assert st["heavy"].n_ok == 10 and st["light"].n_ok == 10
