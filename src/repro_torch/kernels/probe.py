"""A per-thread log of the kernel dispatches one caller makes.

The plan verifier's structure scope (``repro_torch.analysis``) runs a
plan on a probe batch and reads what it dispatched. It cannot read the
launch counters (``conv.LAUNCHES`` and its siblings): they are shared by
every thread, and a tenant's hot swap is verified while the router's
scheduler serves the other tenants. So the wrappers also report to this
log, which exists only on the thread that opened it with
:func:`recording` and only while it is open; every other caller pays one
thread-local lookup.

Three kinds of entries: a **dispatch** is one call of a kernel wrapper
to its kernel or its plain version (``ops.py``), and marks the ops run
inside it as the kernel's own (``DispatchLog.depth``); a **launch** is
one kernel launch on the card (a single-layer call over column strips
launches several), with the dynamic shared memory it requested, which
the verifier's resource scope reads; a **transfer** is one hand-off of
an activation over an interior edge of the spatial pipeline
(``core/dhm/pipeline.py``), which the verifier's pipeline scope reads.

A CUDA graph of the kernels (``core/dhm/engine.py``, ``JittedForward``)
runs no wrapper when it replays. So the launch counts of the kernels
that log here are registered (:func:`counted`): a capture records its
launches under :func:`recording` and takes back their counts
(:func:`uncount`), since a capture launches nothing, and each replay
adds them again, to the counts and to the open log (:func:`replayed`).
A replay of the Engine's mesh rung also makes the pipeline's edge
hand-offs its capture recorded: it logs them again too.

A capture's launches are not all made on the capturing thread. A
captured train step runs its backward on autograd's device thread, on
the stream of each forward op, the capturing one; a remat recompute
there launches the forward's kernels again (falcon-mamba's ``ssm_scan``).
That thread has no log open. So a capture also registers its log by the
stream it records (:func:`capturing`), and a launcher reports the stream
it launched on: a launch onto a stream under capture lands in that
capture's log, from whatever thread, once, beside the launching thread's
own log if that is another. A launch onto any other stream (a Router
tenant's eager call from its own thread) never enters it. The table
holds one entry at a time: ``cuda_graphs.capture`` registers under its
process-wide ``CAPTURE_LOCK``.

A **span** (:func:`span`, names ``repro_torch.*``) names a stretch of the
program. With no ``torch.profiler`` running and no capture open it does
nothing past one check of the profiler and one thread-local lookup. Under
a running profiler it is a ``torch.profiler.record_function``, on the
device trace's clock. Inside a capture that counts its graph's operations
(:func:`capturing` given ``nodes``; ``cuda_graphs.capture`` counts them
for a capture that names its owner) it also writes a **mark** into the
capture's log at its entry and its exit:
its name, its depth and the number of device operations (kernel, memcpy
and memset nodes) the capture's graph holds then. A replay runs no
Python, so those marks are what names a replay's device time: a graph
captured on one stream is a chain, its operations run in capture order,
and :func:`phase_table` cuts them by the marks into (span path, number
of operations) phases. A captured train step's backward launches on
autograd's device thread while the capturing thread waits inside its
span, so its operations fall between that span's marks.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

import torch
from torch.autograd import _profiler_enabled

_local = threading.local()
_NOOP = contextlib.nullcontext()
_TABLES: dict = {}  # kernel name -> the LAUNCHES dict that counts it
_CAPTURES: dict = {}  # raw CUDA stream handle under capture -> its DispatchLog


class DispatchLog:
    """What one thread dispatched while its log was open. ``phase`` is a
    label the caller sets (the verifier uses ``"features"`` and
    ``"head"``); each entry carries the phase it was made in."""

    def __init__(self):
        self.phase = ""
        self.depth = 0
        self.dispatches: list = []  # (phase, kernel name, plain version?)
        self.launches: list = []  # (phase, kernel name, dynamic shared-memory bytes)
        self.transfers: list = []  # (edge class, (src stage, dst stage), buffer shape)
        # A capture's log only: the count of its graph's device operations
        # (:func:`capturing`), and the spans' marks, (name, depth, entry?,
        # operations) each.
        self.nodes: Optional[Callable[[], int]] = None
        self.marks: list = []
        self.spans = 0


def active() -> Optional[DispatchLog]:
    """The calling thread's open log, or None."""
    return getattr(_local, "log", None)


@contextlib.contextmanager
def recording():
    """Open a log on the calling thread for the duration of the block."""
    log, prev = DispatchLog(), active()
    _local.log = log
    try:
        yield log
    finally:
        _local.log = prev


@contextlib.contextmanager
def attached(log: Optional[DispatchLog]):
    """Make ``log`` (a log another thread opened, or None for none) the
    calling thread's log for the duration of the block: a backward that
    autograd runs on its own device thread logs into its forward caller's
    log, which waits on it."""
    prev = active()
    _local.log = log
    try:
        yield log
    finally:
        _local.log = prev


@contextlib.contextmanager
def capturing(stream: int, log: DispatchLog, nodes: Optional[Callable[[], int]] = None):
    """Route every launch onto ``stream`` (a raw CUDA stream handle, the
    one each launcher launches on) into ``log`` for the duration of the
    block, whichever thread makes it: the stream capture's log. ``nodes()``
    counts the device operations the capture's graph holds; given, the
    spans opened on the thread mark the log."""
    _CAPTURES[stream] = log
    log.nodes = nodes
    try:
        yield log
    finally:
        _CAPTURES.pop(stream, None)
        log.nodes = None


class _Marked:
    """A span inside a capture: marks the capture's log at entry and exit,
    and is a ``record_function`` besides while a profiler runs."""

    __slots__ = ("log", "name", "inner")

    def __init__(self, log: DispatchLog, name: str):
        self.log, self.name = log, name
        self.inner = torch.profiler.record_function(name) if _profiler_enabled() else None

    def __enter__(self):
        log = self.log
        log.spans += 1
        log.marks.append((self.name, log.spans, True, log.nodes()))
        if self.inner is not None:
            self.inner.__enter__()

    def __exit__(self, *exc):
        if self.inner is not None:
            self.inner.__exit__(*exc)
        log = self.log
        log.marks.append((self.name, log.spans, False, log.nodes()))
        log.spans -= 1


def span(name: str):
    """``with span("repro_torch.x"):`` names the block (the module's
    spans)."""
    log = getattr(_local, "log", None)
    if log is not None and log.nodes is not None:
        return _Marked(log, name)
    if not _profiler_enabled():
        return _NOOP
    return torch.profiler.record_function(name)


def phase_table(marks, total: int) -> tuple:
    """A capture's phases from its marks and its graph's count of device
    operations: ((span path, operations), ...) in capture order, the path
    the span names from the outermost down joined by ``/`` ("" outside
    every span), each stretch with no operation left out and neighbours
    of one path merged."""
    table, stack, at = [], [], 0

    def cut(upto: int) -> None:
        nonlocal at
        if upto > at:
            path = "/".join(stack)
            if table and table[-1][0] == path:
                table[-1] = (path, table[-1][1] + upto - at)
            else:
                table.append((path, upto - at))
            at = upto

    for name, _, entry, n in marks:
        cut(n)
        if entry:
            stack.append(name)
        else:
            stack.pop()
    cut(total)
    return tuple(table)


class dispatch:
    """``with dispatch(name, plain=...):`` around a wrapper's call of its
    kernel launcher or its plain version: logs the dispatch and marks the
    block as inside the kernel."""

    __slots__ = ("log",)

    def __init__(self, name: str, *, plain: bool):
        self.log = active()
        if self.log is not None:
            self.log.dispatches.append((self.log.phase, name, plain))

    def __enter__(self):
        if self.log is not None:
            self.log.depth += 1

    def __exit__(self, *exc):
        if self.log is not None:
            self.log.depth -= 1


def launched(name: str, smem: int, stream: Optional[int] = None) -> None:
    """Log one launch of kernel ``name`` (beside its ``LAUNCHES`` count)
    and the dynamic shared memory, in bytes, its launcher requested, in
    the calling thread's open log and, where ``stream`` (the raw handle
    it launched on) is under capture, in the capture's log."""
    log = active()
    if log is not None:
        log.launches.append((log.phase, name, int(smem)))
    cap = _CAPTURES.get(stream) if _CAPTURES and stream is not None else None
    if cap is not None and cap is not log:
        cap.launches.append((cap.phase, name, int(smem)))


def transferred(edge_class: int, pair: tuple, shape: tuple) -> None:
    """Log one hand-off over an interior pipeline edge: the edge's shape
    class, its (source, destination) stages and the buffer's shape."""
    log = active()
    if log is not None:
        log.transfers.append((edge_class, tuple(pair), tuple(shape)))


def counted(table: dict) -> dict:
    """Register a kernel module's ``LAUNCHES`` (kernel name -> count), so
    that a graph's capture and replays can adjust the counts by name."""
    for name in table:
        _TABLES[name] = table
    return table


def uncount(launches) -> None:
    """Take back the counts of the launches a stream capture logged,
    ``(phase, name, smem)`` each: the capture recorded them, and launched
    nothing."""
    for _, name, _ in launches:
        _TABLES[name][name] -= 1


def replayed(launches, transfers=()) -> None:
    """Count the launches one replay of a captured graph makes,
    ``(name, smem)`` each, as the wrappers count theirs: in ``LAUNCHES``
    and in the calling thread's open log; and log the edge transfers it
    makes, ``(edge class, (src, dst), shape)`` each, there too."""
    log = active()
    for name, smem in launches:
        _TABLES[name][name] += 1
        if log is not None:
            log.launches.append((log.phase, name, int(smem)))
    if log is not None:
        log.transfers.extend(transfers)
