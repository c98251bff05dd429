"""Stage IO geometry and the dispatch watchdog.

The part of ``repro.core.dhm.pipeline`` that single-device execution and
the serving ``Engine`` use: :class:`StageIOSpec` (the per-stage
activation geometry the compiler emits), :class:`CollectiveTimeout` and
:func:`call_with_timeout`. The mesh executor lands in a later slice.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional


class CollectiveTimeout(RuntimeError):
    """A dispatched step failed to complete within its deadline. The
    serving engine treats this as a rung-level failure and demotes instead
    of hanging."""


def call_with_timeout(fn: Callable, *, timeout_s: Optional[float], what: str = "dispatch"):
    """Run ``fn()`` (which must block until its result is ready) under a
    watchdog: if it does not return within ``timeout_s``, raise
    :class:`CollectiveTimeout` — the caller regains control even though
    the wedged computation cannot be cancelled (the worker thread is
    abandoned as a daemon and its eventual result discarded).

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

    t = threading.Thread(target=_run, daemon=True, name=f"watchdog-{what}")
    t.start()
    if not done.wait(timeout_s):
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
