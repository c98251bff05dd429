"""Deterministic fault injection for the DHM serving engine.

The counterpart of ``repro.core.dhm.faults``, pure Python and the same
schedule: given the same faults and seed, a :class:`FaultPlan` fires on
exactly the events the reference's fires on. It simulates the failure
classes a serving runtime meets (wedged dispatches, transient launch
failures, corrupted activations, lost devices) **deterministically**
(seed-driven, counter-triggered), so the chaos tests can assert the
engine's contract under each of them: structured per-request errors or a
one-rung demotion, never a hang or a crash.

A :class:`FaultPlan` is a sequence of fault specs plus a seed. The engine
consults it at two hook points:

- ``on_flush()`` — before a flush packs its batch (:class:`DelayedFlush`
  sleeps here, so deadline handling can be exercised);
- ``dispatch_effects(rung=...)`` — before each micro-batch dispatch;
  returns the :class:`DispatchEffects` to apply *inside* the timed
  dispatch call (a pre-dispatch stall, a raised error, or a
  NaN-corruption of the activations at a chosen stage boundary).

Each fault fires on a trigger window of dispatch/flush events
(``at``-th event onwards, for ``times`` events; ``times=None`` = forever)
or probabilistically via the plan's seeded RNG (``prob``), and can be
restricted to one execution-ladder rung (the port's Engine has the rungs
``"fused"`` and ``"per_layer"``) and/or to one serving **tenant**
(``tenant="A"``: only tenant A's engine sees it, the blast radius the
multi-tenant router's bulkheads must contain). Event counters are kept
**per tenant** (the ``None`` tenant is the single-engine stream), so
"fault A's 2nd dispatch" stays deterministic no matter how B's traffic
interleaves. Everything is reproducible from ``(faults, seed)`` — no
wall-clock or global randomness.
"""
from __future__ import annotations

import dataclasses
import random
import threading
from typing import Optional, Sequence


class InjectedFault(RuntimeError):
    """Base class of all errors raised *by* injected faults (so tests and
    the engine can tell simulated failures from real ones)."""


class InjectedDispatchError(InjectedFault):
    """A transient dispatch failure (the kind retry-with-backoff heals)."""


class InjectedDeviceLoss(InjectedFault):
    """A device dropped out of the mesh — not transient: the engine must
    demote off the affected rung immediately rather than retry into it."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """Base fault spec: a trigger window over the fault's event counter.

    ``at``: 0-based event index the window opens at (counted per tenant).
    ``times``: events the window stays open for (``None`` = forever).
    ``prob``: if > 0, ignore the window and fire per-event with this
      probability from the plan's seeded RNG (deterministic per seed).
    ``rung``: only fire while the engine serves on this ladder rung
      (``None`` = any rung; the port's rungs are ``"fused"`` and
      ``"per_layer"``). Flush-scoped faults ignore it.
    ``tenant``: only fire for the engine serving this tenant (``None`` =
      any tenant, including the untenanted single-engine stream). A
      tenant-scoped fault never fires for an engine that does not carry
      that tenant name — the bulkhead-isolation contract.
    """

    at: int = 0
    times: Optional[int] = 1
    prob: float = 0.0
    rung: Optional[str] = None
    tenant: Optional[str] = None

    def _in_window(self, count: int) -> bool:
        if count < self.at:
            return False
        return self.times is None or count < self.at + self.times


@dataclasses.dataclass(frozen=True)
class DelayedFlush(Fault):
    """Sleep ``delay_s`` before the flush packs its batch — models a
    stalled flusher/host; requests whose deadline expires during the stall
    must complete with ``DeadlineExceeded``, not block the batch."""

    delay_s: float = 0.05


@dataclasses.dataclass(frozen=True)
class DispatchError(Fault):
    """Raise from inside the dispatch call — a transient launch failure
    (bounded retry-with-backoff is the expected response)."""

    message: str = "injected dispatch failure"


@dataclasses.dataclass(frozen=True)
class StalledDispatch(Fault):
    """Stall ``stall_s`` inside the dispatch call before it runs — models
    a hung kernel; with ``stall_s`` above the engine's dispatch timeout,
    the watchdog fires and the engine demotes one rung instead of hanging
    (the port's abandoned attempt then wakes and launches nothing)."""

    stall_s: float = 0.5


@dataclasses.dataclass(frozen=True)
class NaNActivation(Fault):
    """Corrupt the activations at the boundary after conv stage ``stage``
    with NaNs — models silent data corruption mid-pipeline; the engine's
    output validation must catch the non-finite logits and retry/demote,
    and surviving retries must stay bit-exact."""

    stage: int = 0


@dataclasses.dataclass(frozen=True)
class DeviceLoss(Fault):
    """Raise :class:`InjectedDeviceLoss` from the dispatch call — models
    losing a device. Non-transient: the engine must demote off the rung
    without burning retries."""


@dataclasses.dataclass(frozen=True)
class DispatchEffects:
    """What the fault plan injects into ONE dispatch attempt (applied by
    the engine inside the timed dispatch callable, in this order)."""

    stall_s: float = 0.0
    exc: Optional[BaseException] = None
    corrupt_stage: Optional[int] = None

    @property
    def clean(self) -> bool:
        return not self.stall_s and self.exc is None and self.corrupt_stage is None


class FaultPlan:
    """A deterministic schedule of injected faults.

    ``FaultPlan([DispatchError(at=0, times=2)], seed=0)`` makes the first
    two dispatch attempts raise and every later one run clean — the chaos
    suite asserts a retried batch then completes bit-exact. Thread-safe:
    the engine's flusher thread and callers may consult it concurrently.
    """

    def __init__(self, faults: Sequence[Fault] = (), seed: int = 0):
        for f in faults:
            if not isinstance(f, Fault):
                raise TypeError(f"expected Fault specs, got {f!r}")
        self.faults = tuple(faults)
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        # Event counters are PER TENANT (key None = the untenanted
        # single-engine stream) so a tenant-scoped window is deterministic
        # regardless of how other tenants' traffic interleaves.
        self._flushes: dict = {}
        self._dispatches: dict = {}

    def _fires(
        self, f: Fault, count: int, rung: Optional[str],
        tenant: Optional[str],
    ) -> bool:
        if f.tenant is not None and f.tenant != tenant:
            return False
        if f.rung is not None and rung is not None and f.rung != rung:
            return False
        if f.prob > 0:
            return self._rng.random() < f.prob
        return f._in_window(count)

    # -- hooks ---------------------------------------------------------------

    def on_flush(self, *, tenant: Optional[str] = None) -> float:
        """Seconds the flush should stall before packing (0 = clean).
        Advances ``tenant``'s flush event counter."""
        with self._lock:
            count = self._flushes.get(tenant, 0)
            self._flushes[tenant] = count + 1
            delay = 0.0
            for f in self.faults:
                if isinstance(f, DelayedFlush) and self._fires(
                    f, count, None, tenant
                ):
                    delay += f.delay_s
            return delay

    def dispatch_effects(
        self, *, rung: Optional[str] = None, tenant: Optional[str] = None
    ) -> DispatchEffects:
        """The effects to apply to ``tenant``'s next dispatch attempt on
        ``rung``. Advances ``tenant``'s dispatch event counter."""
        with self._lock:
            count = self._dispatches.get(tenant, 0)
            self._dispatches[tenant] = count + 1
            stall, exc, corrupt = 0.0, None, None
            for f in self.faults:
                if not self._fires(f, count, rung, tenant):
                    continue
                if isinstance(f, StalledDispatch):
                    stall += f.stall_s
                elif isinstance(f, DispatchError):
                    exc = InjectedDispatchError(
                        f"{f.message} (dispatch #{count}, rung {rung})"
                    )
                elif isinstance(f, DeviceLoss):
                    exc = InjectedDeviceLoss(
                        f"injected device loss (dispatch #{count}, rung {rung})"
                    )
                elif isinstance(f, NaNActivation):
                    corrupt = f.stage
            return DispatchEffects(stall_s=stall, exc=exc, corrupt_stage=corrupt)

    # -- introspection (for tests) -------------------------------------------

    @property
    def n_dispatch_events(self) -> int:
        """Total dispatch events across every tenant stream."""
        with self._lock:
            return sum(self._dispatches.values())

    @property
    def n_flush_events(self) -> int:
        """Total flush events across every tenant stream."""
        with self._lock:
            return sum(self._flushes.values())

    def n_dispatch_events_for(self, tenant: Optional[str]) -> int:
        with self._lock:
            return self._dispatches.get(tenant, 0)

    def n_flush_events_for(self, tenant: Optional[str]) -> int:
        with self._lock:
            return self._flushes.get(tenant, 0)
