"""Multi-tenant serving: N compiled plans resident behind one router.

The counterpart of ``repro.core.dhm.multitenant``, on the plans' device
(the card unless the plans were compiled for the CPU). The paper's DHM
thesis is per-actor hardware ownership — independent
workloads never contend for a shared compute engine. This module extends
that isolation guarantee from the layer graph to the *serving* layer:
each tenant (a named :class:`~repro_torch.core.dhm.engine.Engine` around one
compiled plan) owns its queue, admission policy, deadlines, degradation
ladder, watchdog, and retry budget, and a single :class:`Router`
schedules flushes across them. Every thread that dispatches (the
scheduler, the engines' watchdog threads, a probe) makes the plan's
device current first (``engine.on_device``).

Three mechanisms make the bulkheads real:

- **Weighted-fair scheduling** — a deficit-round-robin loop over the
  tenants, with per-group cost priced from the plan's analytic workload
  (the stages' actor FLOPs, as the reference's ``pipeline_workload``
  sums them): a heavy tenant
  (big model, big micro-batch) burns its deficit faster and cannot
  starve a light one. A tenant whose earliest queued deadline is about
  to expire is dispatched immediately (its deficit goes negative — the
  debt is repaid in later rounds, so long-run fairness holds).
- **Per-tenant circuit breakers** — ``K`` consecutive failed flushes
  (request failures or ladder demotions: the BatchFailed / watchdog-
  timeout signal) open the tenant's breaker: its queue is completed with
  :class:`CircuitOpen` and new submits fail fast, so a faulting tenant
  consumes no scheduler turns. After ``breaker_reset_s`` the breaker
  goes half-open and one probe runs: the plan-scope health check
  (``verify_plan(plan, scopes=("plan",))``) plus one real warmup
  dispatch; success closes the breaker, failure re-opens it.
- **Verified hot plan swap** — :meth:`Router.swap` admits a replacement
  plan only after it passes ``verify_plan`` plan+structure scopes (the
  port's verifier runs the plan on a probe batch and counts only the
  probing thread's dispatches, so tenants served meanwhile do not enter
  the counts), a compatibility check (same frame geometry and logits
  width, read off the plan's topology and baked head), and a shadow
  warmup dispatch (the new engine's rung probe —
  it never touches live traffic). The switch is atomic with zero
  dropped in-flight requests: submissions quiesce, the old engine
  drains (pre-swap requests resolve bit-exact through the OLD plan),
  then the tenant's engine reference flips. The old engine is retained
  for one-call :meth:`Router.rollback`.

Chaos testing: give the router a
:class:`~repro_torch.core.dhm.faults.FaultPlan` whose faults carry
``tenant="A"`` — only tenant A's engine sees them, and the suite asserts
tenant B's error rate and p99 stay inside its bulkhead.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.dhm.engine import (
    Engine,
    EngineStats,
    FlusherWedged,
    Rejected,
    Request,
    Shed,
)
from repro_torch.core.dhm.faults import FaultPlan

_LOG = logging.getLogger("repro_torch.dhm.multitenant")


class CircuitOpen(Rejected):
    """The tenant's circuit breaker is open — the request fails fast
    without touching the queue (counted as a rejection in the tenant's
    stats). The breaker half-opens after its reset window and closes
    again once a probe dispatch succeeds."""


class SwapRejected(RuntimeError):
    """:meth:`Router.swap` refused the replacement plan — verification
    findings, an incompatible serving surface, or a failed shadow warmup.
    The old plan is still serving; nothing changed. ``invariants`` lists
    the failed registry IDs when verification rejected the plan."""

    def __init__(self, message: str, invariants=()):
        super().__init__(message)
        self.invariants = tuple(invariants)


class UnknownTenant(KeyError):
    """No tenant registered under that name."""


# Breaker states.
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


@dataclasses.dataclass
class CircuitBreaker:
    """Per-tenant breaker state (mutated only under the tenant's lock).

    ``closed`` -> (K consecutive failed flushes) -> ``open`` ->
    (reset window elapses) -> ``half_open`` -> probe ok -> ``closed``
    / probe fails -> ``open`` again.
    """

    threshold: int
    reset_s: float
    state: str = CLOSED
    consecutive_failures: int = 0
    opened_at: float = 0.0  # time.monotonic() of the last open
    n_opens: int = 0
    n_probes: int = 0

    def record_failure(self) -> bool:
        """Count one failed flush; returns True when this failure opens
        the breaker."""
        self.consecutive_failures += 1
        if self.state == CLOSED and (
            self.consecutive_failures >= self.threshold
        ):
            self.trip()
            return True
        return False

    def record_success(self) -> None:
        self.consecutive_failures = 0

    def trip(self) -> None:
        self.state = OPEN
        self.opened_at = time.monotonic()
        self.n_opens += 1

    def close(self) -> None:
        self.state = CLOSED
        self.consecutive_failures = 0

    @property
    def due_for_probe(self) -> bool:
        return (
            self.state == OPEN
            and time.monotonic() - self.opened_at >= self.reset_s
        )


class _TenantState:
    """Router-internal per-tenant record: the live engine, its DRR
    accounting, breaker, and the swap/rollback bookkeeping."""

    def __init__(self, name: str, plan, engine: Engine, weight: float,
                 breaker: CircuitBreaker):
        self.name = name
        self.plan = plan
        self.engine = engine
        self.weight = weight
        self.breaker = breaker
        self.deficit = 0.0
        self.group_cost = _group_cost(plan, engine)
        # ``lock``/``cv`` guard the engine *reference*, breaker state and
        # the swap protocol; they are never held across a dispatch.
        self.lock = threading.RLock()
        self.cv = threading.Condition(self.lock)
        self.swapping = False  # a swap is quiescing/switching this tenant
        self.inflight_submits = 0  # submits holding the engine reference
        self.previous = None  # (plan, engine) retained for rollback
        self.n_swaps = 0


def _group_cost(plan, engine: Engine) -> float:
    """Analytic cost of ONE dispatch for this tenant — the DRR billing
    unit. Priced from the plan's per-stage FLOP workload (each stage's
    summed actor payloads, what the reference's ``pipeline_workload``
    reads); falls back to frame count when a plan carries no stage
    costs, so scheduling still works."""
    try:
        per_frame = float(sum(float(st.cost_flops) for st in plan.stages))
    except Exception:  # noqa: BLE001 — cost model is advisory
        per_frame = 1.0
    return max(per_frame, 1.0) * engine.group


class Router:
    """N resident tenants behind one weighted-fair scheduler.

    ``router.add("mnist", plan)`` registers a tenant (its own
    :class:`Engine`, queue, SLOs and failure domain); ``router.submit
    ("mnist", x, deadline_ms=...)`` routes a request; a background
    scheduler thread (started by :meth:`start` / the context manager)
    flushes tenants by deficit round-robin. See the module docstring for
    the isolation, breaker, and hot-swap semantics.

    Scheduler/engine knob defaults passed at construction apply to every
    ``add()`` unless overridden per tenant.
    """

    def __init__(
        self,
        *,
        quantum: Optional[float] = None,
        breaker_threshold: int = 3,
        breaker_reset_s: float = 0.25,
        scheduler_interval_ms: float = 2.0,
        deadline_margin_ms: float = 2.0,
        fault_plan: Optional[FaultPlan] = None,
        join_timeout_s: float = 30.0,
        **engine_defaults,
    ):
        if breaker_threshold < 1:
            raise ValueError("breaker_threshold must be >= 1")
        self.breaker_threshold = breaker_threshold
        self.breaker_reset_s = breaker_reset_s
        self.scheduler_interval_ms = scheduler_interval_ms
        self.deadline_margin_ms = deadline_margin_ms
        self.join_timeout_s = join_timeout_s
        self._fault_plan = fault_plan
        self._engine_defaults = dict(engine_defaults)
        self._quantum_cfg = quantum
        self._quantum = quantum or 1.0
        self._tenants: Dict[str, _TenantState] = {}
        self._lock = threading.RLock()  # guards the tenant table
        self._sched_cv = threading.Condition(threading.Lock())
        self._sched_pending = False  # wake arrived while a round was running
        self._scheduler: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()

    # -- tenant table --------------------------------------------------------

    def add(
        self, name: str, plan, *, weight: float = 1.0, **engine_kwargs
    ) -> Engine:
        """Register a tenant: compile-free — the plan is already
        compiled; building the tenant's :class:`Engine` runs its rung
        warmup probe. ``weight`` scales the tenant's share of scheduler
        bandwidth. Engine knobs (``microbatch``, ``max_queue``,
        ``admission``, ``dispatch_timeout_s``, ...) override the
        router-wide defaults."""
        if not name or not isinstance(name, str):
            raise ValueError(f"tenant name must be a non-empty str, got {name!r}")
        if weight <= 0:
            raise ValueError(f"tenant weight must be > 0, got {weight}")
        with self._lock:
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already registered")
        engine = self._build_engine(name, plan, engine_kwargs)
        ts = _TenantState(
            name, plan, engine, weight,
            CircuitBreaker(self.breaker_threshold, self.breaker_reset_s),
        )
        with self._lock:
            if name in self._tenants:  # lost a registration race
                raise ValueError(f"tenant {name!r} already registered")
            self._tenants[name] = ts
            self._recompute_quantum()
        self._wake()
        return engine

    def remove(self, name: str) -> None:
        """Deregister a tenant; its still-queued requests complete with a
        structured :class:`Shed` error (never silently dropped)."""
        ts = self._state(name)
        with self._lock:
            self._tenants.pop(name, None)
            self._recompute_quantum()
        with ts.cv:
            eng = ts.engine
        eng._external_flusher = None
        eng._shed_all(f"tenant {name!r} removed from the router")

    @property
    def tenants(self) -> tuple:
        with self._lock:
            return tuple(self._tenants)

    def engine(self, name: str) -> Engine:
        """The tenant's live engine (reference valid until the next
        swap/rollback)."""
        ts = self._state(name)
        with ts.cv:
            return ts.engine

    def _state(self, name: str) -> _TenantState:
        with self._lock:
            ts = self._tenants.get(name)
        if ts is None:
            raise UnknownTenant(name)
        return ts

    def _build_engine(self, name: str, plan, overrides: dict) -> Engine:
        kwargs = dict(self._engine_defaults)
        kwargs.update(overrides)
        if kwargs.pop("auto_flush", False):
            raise ValueError(
                "router tenants must not run their own flusher "
                "(auto_flush=True); the router's scheduler flushes them"
            )
        kwargs.setdefault("fault_plan", self._fault_plan)
        engine = Engine(plan, name=name, auto_flush=False, **kwargs)
        engine._external_flusher = self._scheduler_alive
        return engine

    def _recompute_quantum(self) -> None:
        # One DRR round must let a weight-1 tenant afford at least one
        # group of the costliest tenant, else heavy tenants starve.
        if self._quantum_cfg is not None:
            return
        costs = [ts.group_cost for ts in self._tenants.values()]
        self._quantum = max(costs) if costs else 1.0

    # -- request path --------------------------------------------------------

    def submit(
        self, tenant: str, x, *, deadline_ms: Optional[float] = None
    ) -> Request:
        """Route one request to ``tenant``. Same contract as
        :meth:`Engine.submit` (structured errors, never hangs), plus:
        while the tenant's breaker is open the request fails fast with
        :class:`CircuitOpen`, and a submit racing a hot swap parks until
        the switch completes (microseconds — the drain happens before
        submissions are blocked out)."""
        ts = self._state(tenant)
        with ts.cv:
            while ts.swapping:
                ts.cv.wait(timeout=1.0)
            eng = ts.engine
            if ts.breaker.state != CLOSED:
                req = eng._new_request(x, deadline_ms=deadline_ms)
                if not req.done:
                    eng._fail(
                        req,
                        CircuitOpen(
                            f"request {req.index}: tenant {tenant!r} circuit "
                            f"breaker {ts.breaker.state} "
                            f"({ts.breaker.consecutive_failures} consecutive "
                            "failed flushes) — retry after the reset window"
                        ),
                    )
                return req
            ts.inflight_submits += 1
        # Enqueue OUTSIDE the tenant lock: a block-policy submit may park
        # until the scheduler drains, and the scheduler takes ts.cv for
        # its turn — holding it here would deadlock.
        try:
            req = eng.submit(x, deadline_ms=deadline_ms)
        finally:
            with ts.cv:
                ts.inflight_submits -= 1
                ts.cv.notify_all()
        self._wake()
        return req

    def infer(self, tenant: str, x, *, deadline_ms: Optional[float] = None):
        """Convenience: submit + result (the scheduler flushes)."""
        return self.submit(tenant, x, deadline_ms=deadline_ms).result()

    # -- circuit breaker -----------------------------------------------------

    def breaker(self, name: str) -> CircuitBreaker:
        """A snapshot of the tenant's breaker."""
        ts = self._state(name)
        with ts.cv:
            return dataclasses.replace(ts.breaker)

    def _shed_queue(self, eng: Engine, why: str) -> int:
        """Complete every request queued on ``eng`` with
        :class:`CircuitOpen` (counted as rejections)."""
        with eng._cv:
            pending, eng._queue = eng._queue, []
            eng._queue_frames = 0
            eng._cv.notify_all()
        for req in pending:
            eng._fail(req, CircuitOpen(f"request {req.index}: {why}"))
        return len(pending)

    def _observe_flush(self, ts: _TenantState, eng: Engine,
                       failed0: int, demoted0: int, ok0: int) -> None:
        """Feed one flush's counter deltas to the tenant's breaker. A
        flush counts as a failure when it failed requests (BatchFailed
        path) or demoted a rung (watchdog timeout / device loss path);
        failure takes precedence over same-flush successes."""
        with eng._lock:
            d_failed = eng._n_failed - failed0
            d_demoted = len(eng.demotions) - demoted0
            d_ok = eng._n_ok - ok0
        with ts.cv:
            if d_failed > 0 or d_demoted > 0:
                if ts.breaker.record_failure():
                    shed = self._shed_queue(
                        eng,
                        f"tenant {ts.name!r} circuit breaker opened after "
                        f"{ts.breaker.consecutive_failures} consecutive "
                        "failed flushes",
                    )
                    _LOG.warning(
                        "tenant %r breaker OPEN (%d queued requests "
                        "completed with CircuitOpen)", ts.name, shed,
                    )
            elif d_ok > 0:
                ts.breaker.record_success()

    def _probe_tenant(self, ts: _TenantState, eng: Engine) -> bool:
        """The half-open probe: the plan-scope registry check plus one
        real (zero-frame) dispatch through the tenant's active rung.
        Never touches queued traffic."""
        from repro_torch.analysis.verify import verify_plan

        try:
            findings = verify_plan(ts.plan, scopes=("plan",))
        except Exception as e:  # noqa: BLE001 — a failed probe re-opens
            _LOG.info("tenant %r probe verification failed: %s", ts.name, e)
            return False
        if any(f.severity == "error" for f in findings):
            _LOG.warning(
                "tenant %r probe failed plan-scope verification: %s",
                ts.name, [f.rule for f in findings],
            )
            return False
        probe = np.zeros((eng.group,) + eng._frame_shape, np.float32)
        try:
            out = eng._run_group(probe)
            return bool(torch.isfinite(out).all())
        except Exception as e:  # noqa: BLE001 — a failed probe re-opens
            _LOG.info("tenant %r probe dispatch failed: %s", ts.name, e)
            return False

    # -- verified hot plan swap ---------------------------------------------

    def swap(self, tenant: str, new_plan, **engine_kwargs) -> None:
        """Atomically replace ``tenant``'s plan with ``new_plan``.

        Admission order (all before live traffic is touched):

        1. ``verify_plan(new_plan, scopes=("plan", "structure"))`` — any
           error finding rejects the swap (:class:`SwapRejected` carries
           the failed invariant IDs).
        2. Serving-surface compatibility: the new plan must consume the
           same frame geometry and produce the same logits width (read
           off the topology and the baked head — no dispatch).
        3. A shadow warmup: the replacement :class:`Engine` is built off
           to the side and must pass its rung warmup probe.

        Then the switch: submissions quiesce, the old engine drains (all
        pre-swap requests resolve bit-exact through the OLD plan), the
        engine reference flips, and the breaker resets. The old engine
        is retained — :meth:`rollback` restores it in one call."""
        ts = self._state(tenant)
        self._verify_swap_target(ts, new_plan)
        try:
            new_engine = self._build_engine(tenant, new_plan, engine_kwargs)
        except Exception as e:  # noqa: BLE001 — warmup/build failures reject
            raise SwapRejected(
                f"tenant {tenant!r}: replacement engine failed its shadow "
                f"warmup: {type(e).__name__}: {e}"
            ) from e
        self._switch(ts, new_plan, new_engine, keep_previous=True)
        _LOG.info("tenant %r swapped to a new plan (rollback available)",
                  tenant)

    def rollback(self, tenant: str) -> None:
        """Swap ``tenant`` back to the plan it served before the last
        :meth:`swap` — one call, no re-verification (the old plan already
        proved itself in service)."""
        ts = self._state(tenant)
        with ts.cv:
            if ts.previous is None:
                raise RuntimeError(
                    f"tenant {tenant!r} has no previous plan to roll back to"
                )
            prev_plan, prev_engine = ts.previous
        self._switch(ts, prev_plan, prev_engine, keep_previous=False)
        _LOG.info("tenant %r rolled back to its previous plan", tenant)

    def _verify_swap_target(self, ts: _TenantState, new_plan) -> None:
        from repro_torch.analysis.verify import verify_plan

        findings = [
            f for f in verify_plan(new_plan, scopes=("plan", "structure"))
            if f.severity == "error"
        ]
        if findings:
            ids = sorted({f.rule for f in findings})
            raise SwapRejected(
                f"tenant {ts.name!r}: replacement plan failed verification "
                f"({', '.join(ids)}): "
                + "; ".join(f.message for f in findings[:3]),
                invariants=ids,
            )
        old_sig = _serving_signature(ts.plan)
        new_sig = _serving_signature(new_plan)
        if old_sig is not None and new_sig is not None and old_sig != new_sig:
            raise SwapRejected(
                f"tenant {ts.name!r}: replacement serving surface "
                f"{new_sig} does not match the live plan's {old_sig} "
                "(frame geometry + logits width must be identical for a "
                "hot swap)"
            )

    def _switch(self, ts: _TenantState, plan, engine: Engine,
                keep_previous: bool) -> None:
        with ts.cv:
            ts.swapping = True
            # Quiesce: wait out submits already holding the old engine
            # reference (ts.cv released while waiting; new submits park).
            deadline = time.monotonic() + self.join_timeout_s
            while ts.inflight_submits > 0:
                if not ts.cv.wait(timeout=0.1) and (
                    time.monotonic() > deadline
                ):
                    ts.swapping = False
                    ts.cv.notify_all()
                    raise SwapRejected(
                        f"tenant {ts.name!r}: in-flight submissions did not "
                        f"quiesce within {self.join_timeout_s:.0f}s"
                    )
            old_plan, old_engine = ts.plan, ts.engine
            try:
                # Drain pre-swap requests through the OLD plan (bit-exact
                # with what they would have gotten without the swap). A
                # scheduler turn racing us serializes on the engine's
                # flush lock; either way every request completes.
                while True:
                    if old_engine.flush() == 0:
                        break
            finally:
                ts.plan = plan
                ts.engine = engine
                ts.group_cost = _group_cost(plan, engine)
                ts.deficit = 0.0
                ts.previous = (old_plan, old_engine) if keep_previous else None
                ts.n_swaps += 1
                ts.breaker.close()
                ts.swapping = False
                ts.cv.notify_all()
        with self._lock:
            self._recompute_quantum()
        self._wake()

    # -- weighted-fair scheduler --------------------------------------------

    def _scheduler_alive(self) -> bool:
        t = self._scheduler
        return t is not None and t.is_alive()

    def start(self) -> "Router":
        """Start the scheduler thread (idempotent)."""
        if self._scheduler_alive():
            return self
        self._stop_evt = threading.Event()
        self._scheduler = threading.Thread(
            target=self._sched_loop, daemon=True, name="dhm-router-scheduler"
        )
        self._scheduler.start()
        return self

    def stop(self, *, drain: bool = True) -> None:
        """Stop the scheduler; by default drain every tenant queue (all
        in-flight requests complete). The join is bounded: a wedged
        scheduler sheds the queues with structured errors and raises
        :class:`~repro_torch.core.dhm.engine.FlusherWedged` — never a silent
        leak, never a hang."""
        scheduler = self._scheduler
        if scheduler is not None:
            self._stop_evt.set()
            self._wake()
            scheduler.join(timeout=self.join_timeout_s)
            self._scheduler = None
            if scheduler.is_alive():
                shed = 0
                for name in self.tenants:
                    eng = self.engine(name)
                    shed += eng._shed_all(
                        "router stopping with a wedged scheduler thread"
                    )
                raise FlusherWedged(
                    f"router scheduler did not exit within "
                    f"{self.join_timeout_s:.1f}s of stop(); {shed} queued "
                    "request(s) completed with Shed. A tenant dispatch is "
                    "stuck past its watchdog — inspect the tenants' "
                    "demotion ledgers."
                )
        if drain:
            for name in self.tenants:
                try:
                    self.engine(name).flush()
                except UnknownTenant:
                    pass

    def __enter__(self) -> "Router":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _wake(self) -> None:
        # The pending flag closes the lost-wakeup window: a submit that
        # lands while the scheduler is mid-round (not waiting on the cv)
        # would otherwise be noticed only after a full idle interval.
        with self._sched_cv:
            self._sched_pending = True
            self._sched_cv.notify_all()

    def _sched_loop(self) -> None:
        interval = self.scheduler_interval_ms / 1e3
        margin = self.deadline_margin_ms / 1e3
        while not self._stop_evt.is_set():
            try:
                did_work = self._sched_round(margin)
            except Exception:  # noqa: BLE001 — the loop must survive
                _LOG.exception("scheduler round failed; loop continues")
                did_work = False
            if not did_work:
                with self._sched_cv:
                    if not self._sched_pending:
                        self._sched_cv.wait(timeout=interval)
                    self._sched_pending = False
        # Final drain: whatever arrived before the stop signal.
        for name in self.tenants:
            try:
                self._state(name).engine.flush()
            except Exception:  # noqa: BLE001 — the drain must not raise
                _LOG.exception("final drain failed for tenant %r", name)

    def _sched_round(self, margin: float) -> bool:
        """One deficit-round-robin pass over the tenants; returns True if
        any work (dispatch or probe) was done."""
        did_work = False
        for name in self.tenants:
            try:
                ts = self._state(name)
            except UnknownTenant:
                continue
            probe = False
            with ts.cv:
                if ts.swapping:
                    continue
                eng = ts.engine
                if ts.breaker.state == OPEN:
                    if not ts.breaker.due_for_probe:
                        continue
                    ts.breaker.state = HALF_OPEN
                    ts.breaker.n_probes += 1
                    probe = True
                elif ts.breaker.state == HALF_OPEN:
                    probe = True  # a prior probe round was interrupted
            if probe:
                ok = self._probe_tenant(ts, eng)
                with ts.cv:
                    if ok:
                        ts.breaker.close()
                        _LOG.info("tenant %r breaker CLOSED (probe ok)", name)
                    else:
                        ts.breaker.trip()
                did_work = True
                continue
            did_work |= self._drr_turn(ts, eng, margin)
        return did_work

    def _drr_turn(self, ts: _TenantState, eng: Engine, margin: float) -> bool:
        with eng._cv:
            if not eng._queue:
                ts.deficit = 0.0
                return False
            earliest = min(
                (r.deadline_at for r in eng._queue
                 if r.deadline_at is not None),
                default=None,
            )
        ts.deficit += self._quantum * ts.weight
        urgent = (
            earliest is not None
            and time.perf_counter() >= earliest - margin
        )
        dispatched = False
        while ts.deficit >= ts.group_cost or urgent:
            with eng._lock:
                failed0 = eng._n_failed
                demoted0 = len(eng.demotions)
                ok0 = eng._n_ok
            n = eng.flush(max_frames=eng.group)
            if n == 0:
                ts.deficit = 0.0
                break
            dispatched = True
            urgent = False
            ts.deficit -= math.ceil(n / eng.group) * ts.group_cost
            self._observe_flush(ts, eng, failed0, demoted0, ok0)
            with ts.cv:
                if ts.breaker.state != CLOSED:
                    ts.deficit = 0.0
                    return True
            with eng._cv:
                if not eng._queue:
                    ts.deficit = 0.0
                    break
        return dispatched

    # -- introspection -------------------------------------------------------

    def stats(self) -> Dict[str, EngineStats]:
        """Per-tenant serving stats (each tenant's live engine)."""
        out = {}
        for name in self.tenants:
            try:
                out[name] = self._state(name).engine.stats()
            except UnknownTenant:
                pass
        return out

    def describe(self) -> Dict[str, dict]:
        """Operator view: per tenant — rung, breaker state/opens, weight,
        swaps, rollback availability."""
        out = {}
        for name in self.tenants:
            try:
                ts = self._state(name)
            except UnknownTenant:
                continue
            with ts.cv:
                out[name] = {
                    "rung": ts.engine.rung,
                    "weight": ts.weight,
                    "group_cost": ts.group_cost,
                    "breaker": ts.breaker.state,
                    "breaker_opens": ts.breaker.n_opens,
                    "breaker_probes": ts.breaker.n_probes,
                    "n_swaps": ts.n_swaps,
                    "rollback_available": ts.previous is not None,
                }
        return out


def _serving_signature(plan):
    """(frame shape, logits width) of a plan — the identity a hot swap
    must preserve: the frame from the topology, the width from the baked
    head's last layer (the verifier's V304 has run that head and held it
    to the topology's classes). None when it cannot be derived
    (verification has already vouched for the surface)."""
    try:
        h, w = plan.topo.input_shape
        frame = (h, w, plan.topo.input_channels)
        fc = plan.fc_params
        width = int(fc[-1]["b"].shape[-1]) if fc else int(plan.topo.n_classes)
        return frame, width
    except Exception:  # noqa: BLE001
        return None
