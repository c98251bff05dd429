"""Stage IO geometry and the dispatch watchdog.

The part of ``repro.core.dhm.pipeline`` that single-device execution and
the serving ``Engine`` use: :class:`StageIOSpec` (the per-stage
activation geometry the compiler emits), :class:`CollectiveTimeout` and
:func:`call_with_timeout`. The mesh executor lands in a later slice.

On the card a watched call that times out must not go on launching
kernels after its caller has retried or demoted: the caller hands the
call a :class:`Watch`, the worker claims it before its first launch, and
a watchdog that gives up first makes the claim fail. Every watchdog
thread is registered until it ends, so a program can wait for all of
them (:func:`join_watchdogs`) before it exits.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional


class CollectiveTimeout(RuntimeError):
    """A dispatched step failed to complete within its deadline. The
    serving engine treats this as a rung-level failure and demotes instead
    of hanging."""


class Watch:
    """The give-up flag one watched call shares with its worker thread.

    The worker calls :meth:`claim` just before its first kernel launch and
    launches only if it gets True; the watchdog calls :meth:`give_up` when
    its timeout passes. The two are atomic against each other, so a worker
    that has not claimed by then never launches. :meth:`sleep` is a stall
    that ends early once the watchdog has given up."""

    def __init__(self):
        self._lock = threading.Lock()
        self._given_up = threading.Event()

    def claim(self) -> bool:
        with self._lock:
            return not self._given_up.is_set()

    def give_up(self) -> None:
        with self._lock:
            self._given_up.set()

    def sleep(self, seconds: float) -> None:
        self._given_up.wait(seconds)


# Every watchdog worker thread of the process, until it ends: a worker
# outlives the call (and the engine) that started it, and a program must
# be able to wait for all of them before it exits.
_WATCHDOGS: set = set()
_WATCHDOGS_LOCK = threading.Lock()


def live_watchdogs() -> int:
    """Watchdog worker threads that have not ended yet."""
    with _WATCHDOGS_LOCK:
        return sum(t.is_alive() for t in _WATCHDOGS)


def join_watchdogs(timeout_s: float) -> int:
    """Wait up to ``timeout_s`` in all for every watchdog worker thread to
    end; returns how many are still running."""
    end = time.monotonic() + timeout_s
    with _WATCHDOGS_LOCK:
        threads = list(_WATCHDOGS)
    for t in threads:
        t.join(max(0.0, end - time.monotonic()))
    return live_watchdogs()


def call_with_timeout(fn: Callable, *, timeout_s: Optional[float], what: str = "dispatch",
                      watch: Optional[Watch] = None):
    """Run ``fn()`` (which must block until its result is ready) under a
    watchdog: if it does not return within ``timeout_s``, give up
    ``watch`` (when one is given) and raise :class:`CollectiveTimeout` —
    the caller regains control even though a computation already running
    cannot be cancelled (the worker thread is left to end on its own and
    its result discarded).

    ``timeout_s=None`` (or <= 0) runs ``fn`` inline with no watchdog.
    """
    if not timeout_s or timeout_s <= 0:
        return fn()
    box: dict = {}
    done = threading.Event()

    def _run():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — relayed to the caller
            box["error"] = e
        finally:
            done.set()
            with _WATCHDOGS_LOCK:
                _WATCHDOGS.discard(threading.current_thread())

    t = threading.Thread(target=_run, daemon=True, name=f"watchdog-{what}")
    with _WATCHDOGS_LOCK:
        _WATCHDOGS.add(t)
    t.start()
    if not done.wait(timeout_s):
        if watch is not None:
            watch.give_up()
        raise CollectiveTimeout(
            f"{what} did not complete within {timeout_s:.3f}s"
        )
    if "error" in box:
        raise box["error"]
    return box["value"]


@dataclasses.dataclass(frozen=True)
class StageIOSpec:
    """Static activation geometry of one pipeline stage: the per-µbatch
    element shape entering and leaving the stage (without the µbatch
    dimension — ``(H, W, C)`` for conv stages). Consecutive stages must
    chain: ``io[s].out_shape == io[s + 1].in_shape``."""

    in_shape: tuple
    out_shape: tuple

    def __post_init__(self):
        for name in ("in_shape", "out_shape"):
            shp = getattr(self, name)
            if not all(isinstance(d, int) and d >= 1 for d in shp):
                raise ValueError(
                    f"StageIOSpec.{name} must be positive ints, got {shp!r}"
                )
