"""Streaming pipelined executor: DHM's "every actor always firing" over
a mesh of slots, for *heterogeneous* stage geometries, and the dispatch
watchdog.

The counterpart of ``repro.core.dhm.pipeline``. The reference is one
controller driving an SPMD program over a device mesh (``shard_map`` +
``lax.switch`` + ``ppermute``). The port is one Python process driving
one *slot* per mesh position (``repro_torch.launch.mesh``): each slot has
a ``torch.device`` and, on CUDA, its own stream. On one H100 every slot
sits on ``cuda:0``, so each stage is its own concurrent stream on the
card; with more cards the slots go round-robin over them and an edge is
a peer copy; on the CPU every slot is ``cpu`` and the ticks run in order.
No ``torch.distributed`` group is used: the reference is single
controller, and NCCL refuses two ranks on one card.

Schedule: GPipe fill/steady/drain, as the reference's. For M µbatches
and S stages the loop runs T = M + S - 1 ticks, and at tick t stage s
takes µbatch t - s. With ``PipelineConfig.overlap=True`` the hand-off of
µbatch m over an edge runs on a copy stream at the tick after its body,
beside the body of µbatch m + 1: T = M + 2(S - 1), and stage s takes
µbatch t - 2s. A tick is the host's enqueue order; on the card the
stages' streams then run as their events allow.

Each interior edge (stage s -> s + 1) travels in its shape class's
buffer (:func:`plan_edges`): exact shape (the default, zero padding) or
the boxed max-shape fallback (``edge_mode="boxed"``), which pads and
unpads as the reference does. Every hand-off is logged on the driving
thread's ``kernels/probe.py`` log (class, (src, dst) stages, buffer
shape), which the verifier's pipeline scope reads. A ``(stage, data)``
mesh gives each data column its own pipeline over its batch shard.

On CUDA: the slots' streams wait on the caller's stream before the first
launch (where the caller copied its frames in); a tensor made on one
stream and read on another is ``record_stream``-ed to its reader, so the
caching allocator cannot hand its memory out while the reader runs; the
caller's stream waits on the last stage's events before it reads the
outputs. Nothing in the executor reads a value to the host.

So ``apply`` can be captured into one CUDA graph from the caller's
stream (the Engine's mesh rung, ``engine._mesh_forward``): the ``start``
event forks every slot stream from the capturing stream; every slot and
copy stream's last work is waited on by a receiver or, for the last
stage, by the caller, which joins them all back before the capture ends;
every allocation is made on a stream in the capture, so it comes from
the graph's pool (a ``record_stream``-ed block freed during the capture
returns to that pool once the capture has ended); and the shape checks
are Python that runs at the warm-up and the capture, never at a replay.
Work that another thread enqueues on a stream under capture is recorded
into the graph, and every runner on a mesh shares its slot streams: an
eager ``apply`` on CUDA holds ``cuda_graphs.CAPTURE_LOCK`` while it
enqueues, so it waits for a capture in progress (and the runner being
captured takes the re-entrant lock again).

Two deliberate deviations from the reference:

(a) fill and drain ticks launch nothing. The reference fires every stage
    every tick on garbage and masks the result; the outputs are the same.
(b) parameters are neither boxed nor stacked (``_box_stage_params``
    exists for ``lax.switch``). Each slot holds its own stage's tensors,
    moved to its device once at build time; ``stacked_leaves`` is the
    per-slot list ``apply`` takes, ``stacked_leaves[s][d]`` for stage s
    in data column d.

The watchdog: a watched call that times out must not go on launching
kernels after its caller has retried or demoted. The caller hands the
call a :class:`Watch`, the worker claims it before its first launch, and
a watchdog that gives up first makes the claim fail. Every watchdog
thread is registered until it ends, so a program can wait for all of
them (:func:`join_watchdogs`) before it exits.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, Optional, Sequence

import torch

from repro_torch import cuda_graphs
from repro_torch.kernels import probe


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


EDGE_MODES = ("auto", "exact", "boxed")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    n_stages: int
    n_microbatches: int
    stage_axis: str = "stage"
    data_axis: Optional[str] = None  # optional batch-sharding mesh axis
    # How interior-edge activations travel (see plan_edges): "auto" sends
    # exact-shape per-class buffers, collapsing to one boxed class only
    # past max_edge_classes; "exact" never collapses; "boxed" forces the
    # single max-shape box (the general fallback).
    edge_mode: str = "auto"
    max_edge_classes: int = 4
    # Hand each edge off on a copy stream beside the next µbatch's stage
    # body (one extra tick of latency per edge).
    overlap: bool = False

    def __post_init__(self):
        if self.n_microbatches < 1 or self.n_stages < 1:
            raise ValueError("n_stages and n_microbatches must be >= 1")
        if self.data_axis is not None and self.data_axis == self.stage_axis:
            raise ValueError("data_axis must differ from stage_axis")
        if self.edge_mode not in EDGE_MODES:
            raise ValueError(
                f"unknown edge_mode {self.edge_mode!r}; expected one of "
                f"{EDGE_MODES}"
            )
        if self.max_edge_classes < 1:
            raise ValueError("max_edge_classes must be >= 1")


# ---------------------------------------------------------------------------
# Boxing: embed heterogeneous shapes in one max-shape buffer.


def _aligned(shape: tuple, rank: int) -> tuple:
    """Rank-align a shape by prepending singleton dims."""
    return (1,) * (rank - len(shape)) + tuple(shape)


def _box_of(shapes: Sequence[tuple]) -> tuple:
    """The elementwise-max box that embeds every (rank-aligned) shape."""
    rank = max(len(s) for s in shapes)
    return tuple(max(dims) for dims in zip(*(_aligned(s, rank) for s in shapes)))


def _fit(a: torch.Tensor, box: tuple) -> torch.Tensor:
    """Zero-pad ``a`` (rank-aligned) into the box shape."""
    a = a.reshape(_aligned(tuple(a.shape), len(box)))
    out = a.new_zeros(box)
    out[tuple(slice(0, d) for d in a.shape)] = a
    return out


def _unfit(a_box: torch.Tensor, shape: tuple) -> torch.Tensor:
    """Slice the true ``shape`` back out of a boxed tensor (inverse of
    :func:`_fit`: exact, no numerics touched)."""
    idx = tuple(slice(0, d) for d in _aligned(shape, a_box.ndim))
    return a_box[idx].reshape(shape)


def _fit_elem(y: torch.Tensor, class_shape: tuple) -> torch.Tensor:
    """Zero-pad a (mb, *elem) activation into (mb, *class_shape): the
    element dims are rank-aligned AFTER the µbatch dim. Pad-free (a pure
    reshape) when the class shape equals the element shape, i.e. on every
    exact-shape edge."""
    el = _aligned(tuple(y.shape[1:]), len(class_shape))
    y = y.reshape((y.shape[0],) + el)
    if el == tuple(class_shape):
        return y
    out = y.new_zeros((y.shape[0],) + tuple(class_shape))
    out[(slice(None),) + tuple(slice(0, d) for d in el)] = y
    return out


def _unfit_elem(y_box: torch.Tensor, shape: tuple) -> torch.Tensor:
    """Slice the true (mb, *shape) activation back out of a class buffer
    (inverse of :func:`_fit_elem`: exact, no numerics touched)."""
    idx = (slice(None),) + tuple(
        slice(0, d) for d in _aligned(tuple(shape), y_box.ndim - 1)
    )
    return y_box[idx].reshape((y_box.shape[0],) + tuple(shape))


# ---------------------------------------------------------------------------
# Edge planning: size the stream to the actual tensor traffic.


@dataclasses.dataclass(frozen=True)
class EdgePlan:
    """How stage-boundary activations travel between slots.

    The pipeline's S-1 *interior* edges (stage s -> s+1; the stage-0 input
    and final output never travel) are grouped into shape classes. Each
    class owns one buffer shape ``class_shapes[c]``; its pairs are exactly
    the class's edges, so per-tick edge traffic is the sum of the true
    edge payloads, not S-1 copies of the global max box.

    ``mode`` is ``"exact"`` when every class holds edges of one shape
    (class buffers carry zero padding: the path every chain-CNN topology
    takes) and ``"boxed"`` when classes were collapsed into a max-shape
    box (the general fallback, numerics identical).
    """

    mode: str
    edge_shapes: tuple  # per interior edge: the exact element shape
    class_shapes: tuple  # per class: the (rank-aligned) buffer elem shape
    edge_class: tuple  # per interior edge: index into class_shapes

    @property
    def n_edges(self) -> int:
        return len(self.edge_shapes)

    @property
    def n_classes(self) -> int:
        return len(self.class_shapes)

    def class_pairs(self, c: int) -> list:
        """The (s, s+1) pairs of class ``c``: every stage s whose out-edge
        belongs to the class."""
        return [
            (e, e + 1) for e in range(self.n_edges) if self.edge_class[e] == c
        ]

    def class_bytes(self, itemsize: int = 4) -> tuple:
        """Per-class buffer bytes for one element (no µbatch dim)."""
        out = []
        for cs in self.class_shapes:
            n = 1
            for d in cs:
                n *= d
            out.append(n * itemsize)
        return tuple(out)

    def padding_fraction(self, itemsize: int = 4) -> float:
        """Fraction of the per-tick edge traffic that is zero padding
        (0.0 on the exact path)."""
        sent = sum(
            self.class_bytes(itemsize)[self.edge_class[e]]
            for e in range(self.n_edges)
        )
        true = sum(
            itemsize * _prod(self.edge_shapes[e]) for e in range(self.n_edges)
        )
        return 1.0 - true / sent if sent else 0.0


def _prod(shape: tuple) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def plan_edges(
    io_specs: Sequence[StageIOSpec],
    *,
    mode: str = "auto",
    max_classes: int = 4,
) -> EdgePlan:
    """Group the pipeline's interior edge shapes into shape classes.

    ``mode="auto"`` emits one class per distinct (rank-aligned) edge shape
    (the exact-shape stream), collapsing everything into a single
    max-shape box only when that would exceed ``max_classes`` buffers;
    ``"exact"`` never collapses; ``"boxed"`` always does.
    """
    if mode not in EDGE_MODES:
        raise ValueError(
            f"unknown edge mode {mode!r}; expected one of {EDGE_MODES}"
        )
    io_specs = tuple(io_specs)
    edges = tuple(
        tuple(io_specs[s].out_shape) for s in range(len(io_specs) - 1)
    )
    if not edges:
        return EdgePlan(
            mode="exact", edge_shapes=(), class_shapes=(), edge_class=()
        )
    rank = max(len(e) for e in edges)
    aligned = [_aligned(e, rank) for e in edges]
    distinct = []
    for a in aligned:
        if a not in distinct:
            distinct.append(a)
    if mode == "boxed" or (mode == "auto" and len(distinct) > max_classes):
        return EdgePlan(
            mode="boxed",
            edge_shapes=edges,
            class_shapes=(_box_of(edges),),
            edge_class=(0,) * len(edges),
        )
    return EdgePlan(
        mode="exact",
        edge_shapes=edges,
        class_shapes=tuple(distinct),
        edge_class=tuple(distinct.index(a) for a in aligned),
    )


def _tree_map(fn, tree):
    """``fn`` over the tensor leaves of a dict / list / tuple tree."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in _tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in _tree_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def derive_io_specs(
    stage_fns: Sequence[Callable], per_stage_params: Sequence, in_shape: tuple,
    *, device=None,
) -> tuple:
    """Chain the stage bodies to recover every boundary's activation
    geometry (for a caller with no compiler plan to emit
    :class:`StageIOSpec` from): each body runs once on a zero µbatch of
    one frame on ``device`` (default: the device of the first parameter
    tensor, else the CPU). The reference interprets the bodies abstractly
    (``jax.eval_shape``); PyTorch has no abstract run of the kernels."""
    if device is None:
        leaves = _tree_leaves(list(per_stage_params))
        device = leaves[0].device if leaves else torch.device("cpu")
    from repro_torch.core.dhm.engine import on_device

    device = torch.device(device)
    specs = []
    shape = tuple(in_shape)
    with torch.inference_mode(), on_device(device):
        for fn, params in zip(stage_fns, per_stage_params):
            out = fn(params, torch.zeros((1,) + shape, dtype=torch.float32, device=device))
            specs.append(StageIOSpec(in_shape=shape, out_shape=tuple(out.shape[1:])))
            shape = tuple(out.shape[1:])
    return tuple(specs)


def _validate_io_chain(io_specs: Sequence[StageIOSpec]):
    for s in range(len(io_specs) - 1):
        if tuple(io_specs[s].out_shape) != tuple(io_specs[s + 1].in_shape):
            raise ValueError(
                f"stage {s} output {tuple(io_specs[s].out_shape)} does not "
                f"chain into stage {s + 1} input "
                f"{tuple(io_specs[s + 1].in_shape)}"
            )


# ---------------------------------------------------------------------------
# The executor.


def _on(stream):
    """Enqueue on ``stream`` (a CUDA stream), or in order on the CPU."""
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def _recorded(stream):
    """An event recorded on ``stream`` now, or None on the CPU."""
    if stream is None:
        return None
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


@dataclasses.dataclass(frozen=True)
class PipelinedRunner:
    """A built spatial pipeline: the executor plus each slot's resident
    stage parameters (DHM's private resources), moved to the slots'
    devices once at build time.

    ``runner(microbatches)`` runs the resident parameters;
    ``runner.apply(leaves, microbatches)`` takes them as an argument (the
    serving ``Engine``'s path); ``apply_with_timeout`` runs ``apply`` under
    the dispatch watchdog.
    """

    cfg: PipelineConfig
    io_specs: tuple
    edge_plan: EdgePlan  # how interior edges travel (see plan_edges)
    stacked_leaves: list  # stacked_leaves[s][d]: stage s's params on slot (s, d)
    _apply: Callable

    def apply(self, leaves, microbatches: torch.Tensor) -> torch.Tensor:
        """Executor: (per-slot params, (M, mb, *elem) µbatches) ->
        (M, mb, *out_elem) final-stage outputs, on the µbatches' device
        and ready on its current stream."""
        return self._apply(leaves, microbatches)

    def apply_with_timeout(
        self, leaves, microbatches: torch.Tensor, *, timeout_s: Optional[float],
        watch: Optional[Watch] = None,
    ) -> torch.Tensor:
        """:meth:`apply` under the :func:`call_with_timeout` watchdog,
        blocked until the card has finished: raises
        :class:`CollectiveTimeout` instead of hanging. The worker claims
        ``watch`` (a fresh one if none is given) before its first launch,
        so a call the watchdog gave up on launches nothing afterwards."""
        watch = Watch() if watch is None else watch

        def _run():
            if not watch.claim():
                raise CollectiveTimeout("the watchdog gave up before the first launch")
            out = self._apply(leaves, microbatches)
            if out.device.type == "cuda":
                torch.cuda.current_stream(out.device).synchronize()
            return out

        return call_with_timeout(
            _run, timeout_s=timeout_s, what="pipelined collective", watch=watch
        )

    def __call__(self, microbatches: torch.Tensor) -> torch.Tensor:
        return self._apply(self.stacked_leaves, microbatches)


def build_pipeline(
    stage_fns: Sequence[Callable],
    stage_params: Sequence,
    *,
    mesh,
    cfg: PipelineConfig,
    io_specs: Optional[Sequence[StageIOSpec]] = None,
    microbatch: Optional[int] = None,
    dtype=torch.float32,
) -> PipelinedRunner:
    """Build the heterogeneous spatial pipeline once: validate the edge
    geometry, move each stage's params to its slots, and close the
    fill/steady/drain executor over the static metadata.

    Args:
      stage_fns: S per-stage callables ``(params_s, x) -> y``; shapes may
        differ per boundary (pool/stride shrink, channel growth).
      stage_params: per-stage param trees (structure and leaf shapes may
        differ per stage).
      mesh: a ``repro_torch.launch.mesh.Mesh`` with ``cfg.stage_axis``
        (and ``cfg.data_axis``); every slot on one device type.
      io_specs: per-stage :class:`StageIOSpec` (the compiler emits these;
        :func:`derive_io_specs` recovers them from the stage bodies).
        Required.
      microbatch: µbatch size (for the data-axis divisibility check at
        build time; otherwise checked at call time).
      dtype: dtype of the activation stream.
    """
    S, M = cfg.n_stages, cfg.n_microbatches
    ax, dax = cfg.stage_axis, cfg.data_axis
    if mesh.shape.get(ax, 0) != S:
        raise ValueError(
            f"mesh axis {ax!r} has {mesh.shape.get(ax, 0)} devices, need {S}"
        )
    D = 1
    if dax is not None:
        if dax not in mesh.shape:
            raise ValueError(f"mesh has no data axis {dax!r}; axes {mesh.axis_names}")
        D = mesh.shape[dax]
        if microbatch is not None and microbatch % D:
            raise ValueError(
                f"µbatch size {microbatch} not divisible by data axis "
                f"{dax!r} ({D} devices)"
            )
    stage_fns = list(stage_fns)
    if len(stage_fns) != S:
        raise ValueError(f"got {len(stage_fns)} stage fns for {S} stages")
    stage_params = list(stage_params)
    if len(stage_params) != S:
        raise ValueError(
            f"got {len(stage_params)} per-stage param trees for {S} stages"
        )
    if io_specs is None:
        raise ValueError(
            "build_pipeline needs io_specs (or use pipeline_forward, which "
            "derives them from the µbatch stream)"
        )
    io_specs = tuple(io_specs)
    if len(io_specs) != S:
        raise ValueError(f"got {len(io_specs)} io specs for {S} stages")
    _validate_io_chain(io_specs)

    edge_plan = plan_edges(
        io_specs, mode=cfg.edge_mode, max_classes=cfg.max_edge_classes
    )
    elem_shape = tuple(io_specs[0].in_shape)
    slots = [
        [mesh.slot(**{ax: s, **({dax: d} if dax else {})}) for d in range(D)]
        for s in range(S)
    ]
    dev_type = {sl.device.type for row in slots for sl in row}
    if len(dev_type) != 1:
        raise ValueError(f"the stage slots mix device types {sorted(dev_type)}")
    (dev_type,) = dev_type
    # Each slot keeps its own stage's params resident (moved once; on one
    # card every slot of a stage shares the same tensors).
    leaves = [
        [_tree_map(lambda t, dv=sl.device: t.to(dv), stage_params[s]) for sl in slots[s]]
        for s in range(S)
    ]
    # The overlapped schedule hands each edge off on a copy stream of its
    # sender's device, beside the sender's next stage body.
    copy_streams = [
        [torch.cuda.Stream(device=sl.device) if cfg.overlap and dev_type == "cuda" else None
         for sl in slots[s]]
        for s in range(S - 1)
    ]
    k = 2 if cfg.overlap else 1
    n_ticks = M + k * (S - 1)

    def _hand_off(s, d, y, ready, stream):
        """Send stage s's output ``y`` (ready after event ``ready``) over
        edge s -> s+1 of column d, on ``stream``: fit it into its class
        buffer (a pad on a boxed edge), move it to the receiver's device,
        log the transfer. Returns (buffer, event after the hand-off)."""
        c = edge_plan.edge_class[s]
        dst = slots[s + 1][d].device
        with _on(stream):
            if ready is not None:
                stream.wait_event(ready)
                y.record_stream(stream)
            buf = _fit_elem(y, edge_plan.class_shapes[c])
            if buf.device != dst:
                buf = buf.to(dst, non_blocking=True)
            probe.transferred(c, (s, s + 1), tuple(buf.shape))
            return buf, _recorded(stream)

    def _apply(leaves, microbatches):
        if dev_type != "cuda":
            return _enqueue(leaves, microbatches)
        with cuda_graphs.CAPTURE_LOCK:  # no capture records this run
            return _enqueue(leaves, microbatches)

    def _enqueue(leaves, microbatches):
        if microbatches.shape[0] != M:
            raise ValueError(
                f"expected {M} microbatches, got {microbatches.shape[0]}"
            )
        if tuple(microbatches.shape[2:]) != elem_shape:
            raise ValueError(
                f"µbatch element shape {tuple(microbatches.shape[2:])} does "
                f"not match stage 0 input {elem_shape}"
            )
        mb = microbatches.shape[1]
        if mb % D:
            raise ValueError(
                f"µbatch size {mb} not divisible by data axis "
                f"{dax!r} ({D} devices)"
            )
        if microbatches.device.type != dev_type:
            raise ValueError(
                f"µbatches on {microbatches.device} cannot run on slots on "
                f"{dev_type}: the pipeline has no fallback between devices"
            )
        loc = mb // D
        cuda = dev_type == "cuda"
        caller = torch.cuda.current_stream(microbatches.device) if cuda else None
        if cuda:
            # The frames were copied in on the caller's stream; every slot
            # (and copy) stream starts after that. The µbatches need no
            # record_stream: the caller's stream waits below on the last
            # stages' events, which every stage-0 read precedes.
            start = _recorded(caller)
            for row in slots:
                for sl in row:
                    sl.stream.wait_event(start)
        recv, send, outs = {}, {}, {}
        for t in range(n_ticks):
            if cfg.overlap:
                # Last tick's sends travel now, beside this tick's bodies.
                for (s, d, m), (y, ev) in send.items():
                    recv[(s + 1, d, m)] = _hand_off(s, d, y, ev, copy_streams[s][d])
                send = {}
            for s in range(S):
                m = t - k * s
                if not 0 <= m < M:
                    continue  # fill / drain: nothing launched (deviation (a))
                for d in range(D):
                    sl = slots[s][d]
                    with _on(sl.stream):
                        if s == 0:
                            x = microbatches[m, d * loc:(d + 1) * loc]
                        else:
                            buf, ev = recv.pop((s, d, m))
                            if cuda:
                                sl.stream.wait_event(ev)
                                buf.record_stream(sl.stream)
                            x = _unfit_elem(buf, io_specs[s].in_shape)
                        y = stage_fns[s](leaves[s][d], x)
                        want = (loc,) + tuple(io_specs[s].out_shape)
                        if tuple(y.shape) != want:
                            raise ValueError(
                                f"stage {s} produced {tuple(y.shape)}, but its "
                                f"StageIOSpec promises {want}"
                            )
                        y = y.to(dtype)
                        if s == S - 1:
                            outs[(m, d)] = (y, _recorded(sl.stream))
                        elif cfg.overlap:
                            send[(s, d, m)] = (y, _recorded(sl.stream))
                        else:
                            recv[(s + 1, d, m)] = _hand_off(s, d, y, None, sl.stream)
        if cuda:
            for y, ev in outs.values():
                caller.wait_event(ev)
                y.record_stream(caller)
        cols = [
            torch.cat([outs[(m, d)][0].to(microbatches.device) for d in range(D)])
            if D > 1 else outs[(m, 0)][0].to(microbatches.device)
            for m in range(M)
        ]
        return torch.stack(cols)

    return PipelinedRunner(
        cfg=cfg, io_specs=io_specs, edge_plan=edge_plan,
        stacked_leaves=leaves, _apply=_apply,
    )


def pipeline_forward(
    stage_fn,
    stage_params,
    microbatches: torch.Tensor,
    *,
    mesh,
    cfg: PipelineConfig,
    io_specs: Optional[Sequence[StageIOSpec]] = None,
):
    """Run the µbatch stream through the spatial pipeline (one-shot sugar
    over :func:`build_pipeline`; for repeated serving build the runner
    once, or use the ``Engine``).

    Args:
      stage_fn: either a sequence of S per-stage callables
        ``(params_s, x) -> y``, or a single callable shared by every stage.
      stage_params: a list of per-stage param trees. With a single shared
        ``stage_fn``, a tree whose leaves are stacked on a leading axis of
        size ``n_stages`` is also accepted.
      microbatches: (M, mb, *elem) stacked µbatch inputs; with
        ``cfg.data_axis`` set, each data column takes its shard of ``mb``.
      mesh: a ``repro_torch.launch.mesh.Mesh``.
      io_specs: per-stage :class:`StageIOSpec`; derived by running the
        stage bodies (:func:`derive_io_specs`) when omitted.

    Returns:
      (M, mb, *out_elem) outputs of the final stage.
    """
    S = cfg.n_stages
    if callable(stage_fn):
        stage_fns = [stage_fn] * S
        if not isinstance(stage_params, (list, tuple)):
            stage_params = [
                _tree_map(lambda l, s=s: l[s], stage_params) for s in range(S)
            ]
    else:
        stage_fns = list(stage_fn)
    if io_specs is None:
        io_specs = derive_io_specs(
            stage_fns, stage_params, tuple(microbatches.shape[2:]),
            device=microbatches.device,
        )
    runner = build_pipeline(
        stage_fns,
        stage_params,
        mesh=mesh,
        cfg=cfg,
        io_specs=io_specs,
        microbatch=microbatches.shape[1],
        dtype=microbatches.dtype,
    )
    return runner(microbatches)


def stack_stage_params(per_stage_params: list):
    """Stack a list of per-stage param trees along a new leading axis
    (homogeneous-stage sugar for :func:`pipeline_forward`)."""
    first = per_stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in per_stage_params]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(
            stack_stage_params([p[i] for p in per_stage_params]) for i in range(len(first))
        )
    return torch.stack(list(per_stage_params), dim=0)


def make_conv_stage(
    *,
    padding: str = "SAME",
    act: str = "relu",
    pool: int = 0,
    pool_stride: int | None = None,
    stride: int = 1,
    act_bits: int | None = None,
    n_out: int = 0,
    kernel: int = 0,
):
    """Build a single-layer pipeline stage body: a compiler-emitted DHM
    actor chain (conv -> bias -> activation (-> pool -> stream quant)) as
    one fused kernel call on ``params = {"w": (K, K, C, N), "b": (N,)}``.

    Thin veneer over :func:`repro_torch.core.dhm.compiler.emit_conv_stage`,
    through the same ``ConvLayerSpec`` as ``compile_dhm`` topologies.
    ``n_out`` and ``kernel`` describe the expected parameter geometry;
    they default to 0 ("any") because the stage body takes its shapes
    from the params at call time. The reference's ``backend=`` has no
    counterpart: the body follows the device of its input.
    """
    from repro_torch.core.dhm.compiler import emit_conv_stage
    from repro_torch.models.cnn import ConvLayerSpec

    spec = ConvLayerSpec(
        n_out=n_out,
        kernel=kernel,
        padding=padding,
        pool=pool,
        act=act,
        stride=stride,
        pool_stride=pool_stride,
    )
    return emit_conv_stage((spec,), act_bits=act_bits)
