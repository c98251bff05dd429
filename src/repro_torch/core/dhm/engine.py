"""Execution + serving for compiled DHM plans.

The counterpart of ``repro.core.dhm.engine``:

- :func:`forward` — the eager stage/head composition on the plan's device.
- :func:`plan_jitted_forward` — the plan's cached end-to-end closure
  (:class:`JittedForward`): on the card one CUDA graph of the plan's
  kernels and head per input shape, captured at its first call and
  replayed after, with no Python between the kernels; the
  ``donate=True`` variant takes its input in a buffer the caller stages
  into (the port's input donation). On the CPU it is the eager
  composition.
- :func:`pipeline_spec` / :func:`build_plan_pipeline` /
  :func:`run_pipelined` — spatial execution on a mesh of slots: the
  plan's per-stage closures and per-edge :class:`StageIOSpec` geometry
  feed the GPipe executor (``pipeline.build_pipeline``), optionally with
  batch sharding on a 2D ``(stage, data)`` mesh.
- :class:`Engine` — the fault-tolerant continuous-batching server.
  Requests carry per-request deadlines (``submit(x, deadline_ms=...)``);
  a background flush loop packs a micro-batch when it fills *or* the
  earliest deadline approaches; admission control bounds the queue
  (``block | reject | shed_oldest``) and validates every frame at the
  gate; dispatch runs under a watchdog timeout with bounded
  retry-with-backoff; persistent failures demote the engine down a
  health-checked ladder (mesh pipeline, when a ``mesh`` is given ->
  fused plan -> per-layer plan). Every rung runs the plan's kernels;
  there is no plain-version rung on the card. Every rung is a
  :class:`JittedForward` closure, captured in the rung's warmup probe
  (a mesh rung whose slots are not all on the plan's card excepted,
  which runs eagerly); with ``donate`` (the default) the engine stages each packed
  batch straight into the closure's input buffer.
  Failures surface as structured per-request errors — ``result()``
  raises, it never hangs. A seed-driven
  :class:`~repro_torch.core.dhm.faults.FaultPlan` injects failures
  deterministically for the chaos tests; the tenant ``name`` scopes them.

Every dispatch runs on the plan's device (``torch.cuda.device``), from
whichever thread makes it. A dispatch its watchdog has given up on
launches nothing afterwards (``pipeline.Watch``): the reference lets a
stalled attempt wake and run its forward, whose result it discards; on
the card that forward would launch kernels after the engine has retried
or demoted.

On the ``mesh`` rung one group of ``microbatch * n_microbatches`` frames
streams through the pipeline as ``n_microbatches`` µbatches, one stream
per stage slot, and the head runs on the caller's stream after the last
stage; with every slot on the plan's card all of it is one CUDA graph (:func:`_mesh_forward`), the counterpart of the reference's
jitted mesh closure, which donates its frames as the other rungs do;
``n_microbatches="auto"`` (or a ``tuning``) takes the geometry
from the throughput model's autotuner. The fault hooks reach the rung as
any other: a device loss demotes without a retry, a stall past the
watchdog raises ``CollectiveTimeout`` and demotes, and the abandoned
attempt launches nothing afterwards.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import cuda_graphs
from repro_torch.core.dhm.faults import FaultPlan, InjectedDeviceLoss
from repro_torch.core.dhm.pipeline import CollectiveTimeout, Watch, call_with_timeout
from repro_torch.kernels import probe

_LOG = logging.getLogger("repro_torch.dhm.engine")


def forward(plan, x: torch.Tensor) -> torch.Tensor:
    """Eager single-device forward: sequential fused stages + FC head
    (the spans ``repro_torch.dhm.stage`` and ``repro_torch.dhm.head``).
    x: (B, H, W, C) NHWC on the plan's device -> logits (B, n_classes)."""
    feats = plan.features(x)
    with probe.span("repro_torch.dhm.head"):
        return plan.head_fn(feats)


_CACHE_LOCK = threading.Lock()


@dataclasses.dataclass
class _Captured:
    """One input shape of a :class:`JittedForward`: its static input and,
    on the card, the graph, its static output, the launches one replay
    makes ((name, shared-memory bytes) each), the pipeline's edge
    transfers it makes and the event after the last replay's output
    copy."""

    static_in: Optional[torch.Tensor] = None
    static_out: Optional[torch.Tensor] = None
    graph: Optional[object] = None  # torch.cuda.CUDAGraph
    launches: tuple = ()
    transfers: tuple = ()
    done: Optional[object] = None  # torch.cuda.Event


class JittedForward:
    """A forward closure ``fn(x) -> logits`` run as one captured
    executable per input shape: the counterpart of the reference's
    ``jax.jit`` of the plan (:func:`plan_jitted_forward`).

    On the card, the first call of each ``(shape, dtype)`` runs ``fn`` once
    eagerly on a side stream (it builds the kernels, sets their shared
    memory and allocates the library workspaces outside the capture; its
    launches are real and counted), then captures ``fn`` on its static
    input into a ``torch.cuda.CUDAGraph`` with its own memory pool, in
    ``thread_local`` mode (other threads may launch and allocate
    meanwhile), by the port's one capture sequence
    (``repro_torch/cuda_graphs.py``). Each call fills the static input,
    replays the graph and returns a clone of the static output; the
    kernels run in the same
    order on the same buffers as eagerly, so the logits are eager
    ``fn``'s bit for bit. A capture that fails raises: nothing falls back
    to the eager composition. A replay runs no wrapper, so the launches
    (and the pipeline's edge transfers) the capture logged are counted
    again at each replay (``kernels/probe.py``). ``captures``, ``replays``
    and ``staged`` (the inputs copied in) count as
    ``cuda_graphs.JittedTrainStep``'s do. A shape's first call leaves its
    seconds in the capture's record (``cuda_graphs.graphs``).

    ``launch_table`` (the plan's ``CompiledDHM.launch_table``, () for
    any other closure) is written into each capture's record.

    ``donate=True`` is the port's input donation: a caller that writes
    its batch into :meth:`input_buffer` and hands that buffer over gets a
    replay with no device copy before it. Otherwise the caller's tensor
    is copied in and left as it was.

    On the CPU, the closure is the eager composition (same API;
    ``_cache_size()`` counts the shapes it has run).

    The closure records no autograd graph: like the reference's jitted
    closure, it treats the plan's parameters as constants. Gradients go
    through the eager composition (``forward``, ``cnn_apply``).

    A graph's static buffers are shared: ``lock`` (reentrant) is held
    around staging, replay and the output copy; a caller that stages
    into :meth:`input_buffer` holds it from there to the call.
    """

    def __init__(self, fn: Callable, device, *, donate: bool = False,
                 launch_table: tuple = ()):
        self.fn = fn
        self.device = torch.device(device)
        self.donate = donate
        self.launch_table = tuple(launch_table)
        self.lock = threading.RLock()
        self.staged = self.captures = self.replays = 0
        self._shapes: dict = {}  # (shape, dtype) -> _Captured
        self._stream = None  # the side stream of warm-ups and captures

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def _cache_size(self) -> int:
        """The input shapes captured (on the CPU: run) so far."""
        return len(self._shapes)

    def _entry(self, shape: tuple, dtype):
        """The shape's entry, captured first if new, and the capture's
        record where this call made it (else None)."""
        key = (tuple(shape), dtype)
        entry = self._shapes.get(key)
        record = None
        if entry is None:
            entry = _Captured()
            if self.on_card:
                entry, record = self._capture(key)
            self._shapes[key] = entry
        return entry, record

    def _capture(self, key: tuple) -> tuple:
        static_in = torch.zeros(key[0], dtype=key[1], device=self.device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        cap = cuda_graphs.capture(lambda: self.fn(static_in), self.device, self._stream,
                                  owner="JittedForward", key=key)
        cap.record.launch_table = self.launch_table
        self.captures += 1
        return _Captured(static_in=static_in, static_out=cap.out, graph=cap.graph,
                         launches=cap.launches, transfers=cap.transfers), cap.record

    def input_buffer(self, shape, dtype=torch.float32) -> torch.Tensor:
        """The static input for ``shape`` (captured first if new), free to
        write once the last replay has read it."""
        t_call = time.perf_counter()
        with self.lock, torch.inference_mode(False), torch.no_grad():
            entry, record = self._entry(shape, dtype)
            if record is not None:
                cuda_graphs.first_call_done(record, t_call)
            if not self.on_card:
                if entry.static_in is None:
                    entry.static_in = torch.zeros(tuple(shape), dtype=dtype)
                return entry.static_in
            if entry.done is not None:
                torch.cuda.current_stream(self.device).wait_event(entry.done)
            return entry.static_in

    def __call__(self, x) -> torch.Tensor:
        """x: (B, H, W, C) frames -> logits (B, n_classes) on the closure's
        device."""
        t_call = time.perf_counter()
        x = torch.as_tensor(x)
        with self.lock, torch.inference_mode(False), torch.no_grad():
            entry, record = self._entry(x.shape, x.dtype)
            if not self.on_card:
                return self.fn(x)
            stream = torch.cuda.current_stream(self.device)
            if entry.done is not None:
                stream.wait_event(entry.done)
            if not (self.donate and x is entry.static_in):
                entry.static_in.copy_(x)
                self.staged += 1
            entry.graph.replay()
            probe.replayed(entry.launches, entry.transfers)
            self.replays += 1
            out = entry.static_out.clone()
            if entry.done is None:
                entry.done = torch.cuda.Event()
            entry.done.record(stream)
            if record is not None:
                cuda_graphs.first_call_done(record, t_call)
            return out


def plan_jitted_forward(plan, *, donate: bool = False) -> JittedForward:
    """The plan's cached end-to-end closure (conv stages + FC head as one
    captured CUDA graph per input shape on the card: no Python between
    the kernels once captured), built once per plan and donation flag, so
    ``plan_jitted_forward(p) is plan_jitted_forward(p)``.

    ``donate=True`` returns the variant whose :meth:`JittedForward.
    input_buffer` the serving ``Engine`` stages each batch into, so the
    replay needs no device copy of its input; the default copies the
    caller's tensor in and leaves it unchanged.
    """
    with _CACHE_LOCK:
        cache = getattr(plan, "_fwd_cache", None)
        if cache is None:
            cache = {}
            object.__setattr__(plan, "_fwd_cache", cache)
        if donate not in cache:
            cache[donate] = JittedForward(
                lambda xb: forward(plan, xb), plan.device, donate=donate,
                launch_table=plan.launch_table,
            )
        return cache[donate]


def pipeline_spec(plan):
    """The heterogeneous pipeline description of a compiled plan: per-stage
    closures, per-stage params, and the per-edge activation geometry
    (:class:`~repro_torch.core.dhm.pipeline.StageIOSpec` per stage,
    computed by the compiler from the topology)."""
    return (
        [st.fn for st in plan.stages],
        [plan.stage_params(s) for s in range(plan.n_stages)],
        tuple(st.io for st in plan.stages),
    )


def build_plan_pipeline(plan, *, mesh, cfg, microbatch=None):
    """Build the plan's spatial-pipeline runner once (each stage's params
    resident on its slots), the repeated-serving path the ``Engine``
    takes. A mesh whose slots are on another device type than the plan's
    raises: a CUDA plan never runs a CPU slot, nor a CPU plan a card's."""
    from repro_torch.core.dhm.pipeline import build_pipeline

    bad = sorted({str(d) for d in mesh.devices if d.type != plan.device.type})
    if bad:
        raise ValueError(
            f"the mesh's slots on {bad} cannot run a plan on {plan.device}"
        )
    stage_fns, stage_params, io_specs = pipeline_spec(plan)
    return build_pipeline(
        stage_fns, stage_params, mesh=mesh, cfg=cfg, io_specs=io_specs,
        microbatch=microbatch,
    )


def _mesh_forward(plan, mesh, cfg, microbatch: int, *, donate: bool = False):
    """The Engine's mesh rung as ``(runner, fwd)``: the plan's pipelined
    runner, built once on the mesh's slots (each stage's params resident
    there), and ``fwd(frames) -> logits``, the counterpart of the
    reference's jitted mesh closure: the group reshaped into
    ``cfg.n_microbatches`` µbatches of ``microbatch``, streamed through
    the stages, then the head on the caller's stream.

    ``fwd`` is a :class:`JittedForward` (:func:`_mesh_jitted`): on the card
    one CUDA graph of the stage bodies on the slots' streams, the edge
    hand-offs and the head, per input shape; on the CPU the eager
    composition. Other runners on the same mesh share its slot streams:
    their eager work holds the capture lock (``cuda_graphs.CAPTURE_LOCK``),
    so none of it is recorded into the graph."""
    runner = build_plan_pipeline(plan, mesh=mesh, cfg=cfg, microbatch=microbatch)
    n_mb = cfg.n_microbatches

    def _fwd(xb):
        feats = runner.apply(runner.stacked_leaves,
                             xb.reshape((n_mb, microbatch) + tuple(xb.shape[1:])))
        return plan.head_fn(feats.reshape((n_mb * microbatch,) + tuple(feats.shape[2:])))

    return runner, _mesh_jitted(_fwd, plan.device, mesh.devices, donate=donate)


def _mesh_jitted(fn: Callable, device, slot_devices, *, donate: bool) -> Callable:
    """``fn`` as a :class:`JittedForward` on ``device`` when every slot lies
    on ``device``; else ``fn`` itself, run eagerly, with one warning naming
    the devices: one CUDA graph cannot span cards."""

    def _named(d):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        return str(d)

    devices = sorted({_named(d) for d in slot_devices})
    if devices != [_named(device)]:
        _LOG.warning(
            "the mesh rung's slots lie on %s and its plan on %s: one CUDA "
            "graph cannot span devices, so the rung runs eagerly",
            devices, _named(device),
        )

        def _eager(xb):
            with torch.no_grad():
                return fn(xb)

        return _eager
    return JittedForward(fn, device, donate=donate)


def run_pipelined(
    plan, microbatches, *, mesh, cfg=None, data_axis=None,
    overlap=False, edge_mode="auto",
):
    """Stream (M, mb, H, W, C) µbatches through the plan's conv stages on
    a mesh (one slot per stage; heterogeneous stage shapes flow over
    exact-shape-class edges, ``edge_mode="boxed"`` forces the max-shape
    fallback, ``overlap=True`` hands edges off on copy streams). Returns
    the feature stream; apply ``plan.head_fn`` after re-flattening for
    logits."""
    from repro_torch.core.dhm.pipeline import PipelineConfig

    if cfg is None:
        cfg = PipelineConfig(
            plan.n_stages, microbatches.shape[0], data_axis=data_axis,
            overlap=overlap, edge_mode=edge_mode,
        )
    runner = build_plan_pipeline(
        plan, mesh=mesh, cfg=cfg, microbatch=microbatches.shape[1]
    )
    return runner(microbatches)


def on_device(device: torch.device):
    """The context a thread launches on ``device`` in: that card made
    current (``torch.cuda.device``), or nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


# ---------------------------------------------------------------------------
# Structured per-request errors.


class RequestError(RuntimeError):
    """Base class of structured per-request serving failures."""


class DeadlineExceeded(RequestError):
    """The request's SLO deadline passed before it could be dispatched."""


class Rejected(RequestError):
    """Admission control turned the request away (queue full, policy
    ``reject``)."""


class Shed(Rejected):
    """The request was admitted but later evicted (queue full, policy
    ``shed_oldest``, or the engine stopped with a wedged flusher)."""


class InvalidRequest(RequestError):
    """Gate validation failed the request (non-finite frames / bad dtype)."""


class BatchFailed(RequestError):
    """The request's batch failed on every rung of the execution ladder."""


class LadderExhausted(RuntimeError):
    """Every rung of the execution ladder failed for the current batch."""


class FlusherWedged(RuntimeError):
    """``stop()`` could not join the background flush thread within its
    timeout. Every still-queued request was completed with :class:`Shed`
    first, so nothing hangs."""


class _PoisonedBatch(RuntimeError):
    """Internal: a packed batch carries non-finite input frames — rerun
    the requests isolated instead of retrying or demoting."""


class _NonFiniteOutput(RuntimeError):
    """Internal: a dispatch produced non-finite logits from finite inputs
    — transient, retry then demote."""


ADMISSION_POLICIES = ("block", "reject", "shed_oldest")


@dataclasses.dataclass
class Request:
    """One submitted inference request (a batch of frames). Completes
    exactly once: with logits (``result()`` returns a CPU tensor) or with
    a structured :class:`RequestError` (``result()`` raises)."""

    index: int
    n_frames: int
    submitted_at: float
    deadline_at: Optional[float]
    _engine: "Engine"
    _frames: Optional[np.ndarray] = None
    _result: Optional[torch.Tensor] = None
    _error: Optional[BaseException] = None
    done_at: Optional[float] = None
    _event: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False
    )

    @property
    def done(self) -> bool:
        return self._event.is_set()

    @property
    def ok(self) -> bool:
        return self._result is not None

    @property
    def error(self) -> Optional[BaseException]:
        return self._error

    @property
    def latency_s(self) -> float:
        if self.done_at is None:
            raise RuntimeError("request not finished; call result() first")
        return self.done_at - self.submitted_at

    def result(self, timeout: Optional[float] = None) -> torch.Tensor:
        """Logits for this request's frames. Flushes the queue if no
        background flusher runs (or waits for it, up to ``timeout``
        seconds). Raises the request's structured error — never hangs."""
        if not self._event.is_set():
            if self._engine._flusher_alive():
                budget = 60.0 if timeout is None else timeout
                if not self._event.wait(budget):
                    raise TimeoutError(
                        f"request {self.index} not completed within "
                        f"{budget:.1f}s — flusher wedged?"
                    )
            else:
                self._engine.flush()
        if self._error is not None:
            raise self._error
        if self._result is None:
            raise RuntimeError(
                f"request {self.index} was not completed by flush(); resubmit"
            )
        return self._result


_LAT_WINDOW = 2048


def _percentile_ms(samples, q: float) -> float:
    """q-th percentile of a latency sample list, in milliseconds
    (nearest-rank; 0.0 on an empty pool)."""
    if not samples:
        return 0.0
    xs = sorted(samples)
    idx = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[idx] * 1e3


def _pack_logits(outs: list, n: int) -> torch.Tensor:
    """The first ``n`` rows of the micro-batches' host logits, packed with
    numpy as the reference packs them (one micro-batch is sliced, not
    copied)."""
    if len(outs) == 1:
        return outs[0][:n]
    return torch.from_numpy(np.concatenate([o.numpy() for o in outs], axis=0)[:n])


@dataclasses.dataclass(frozen=True)
class EngineStats:
    """Aggregate serving statistics since construction (or the last
    :meth:`Engine.reset_stats`), with p50/p99 per execution-ladder rung."""

    n_requests: int
    n_frames: int
    n_batches: int
    busy_s: float  # wall time spent inside flush()
    mean_latency_s: float
    max_latency_s: float
    n_ok: int = 0
    n_rejected: int = 0
    n_shed: int = 0
    n_deadline_exceeded: int = 0
    n_invalid: int = 0
    n_failed: int = 0
    n_retries: int = 0
    n_demotions: int = 0
    rung: str = ""
    rung_latency_ms: dict = dataclasses.field(default_factory=dict)

    @property
    def frames_per_s(self) -> float:
        return self.n_frames / self.busy_s if self.busy_s > 0 else 0.0

    @property
    def n_errors(self) -> int:
        return (
            self.n_rejected + self.n_shed + self.n_deadline_exceeded
            + self.n_invalid + self.n_failed
        )

    def summary(self) -> str:
        s = (
            f"{self.n_requests} requests / {self.n_frames} frames in "
            f"{self.n_batches} micro-batches: {self.frames_per_s:.0f} "
            f"frames/s, latency mean {self.mean_latency_s * 1e3:.2f} ms "
            f"max {self.max_latency_s * 1e3:.2f} ms"
        )
        if self.n_errors:
            s += (
                f"; errors: {self.n_rejected} rejected, {self.n_shed} shed, "
                f"{self.n_deadline_exceeded} deadline-exceeded, "
                f"{self.n_invalid} invalid, {self.n_failed} failed"
            )
        if self.n_retries:
            s += f"; {self.n_retries} dispatch retries"
        if self.n_demotions:
            s += f"; {self.n_demotions} demotions"
        if self.rung:
            s += f" (rung: {self.rung})"
        for rung, lat in self.rung_latency_ms.items():
            s += (
                f"\n  rung {rung}: p50 {lat['p50_ms']:.2f} ms "
                f"p99 {lat['p99_ms']:.2f} ms ({lat['n']} samples)"
            )
        return s


class Engine:
    """Fault-tolerant continuous-batching server around a
    :class:`CompiledDHM` plan, on the plan's device.

    Requests enter a bounded queue via :meth:`submit`, optionally with a
    latency SLO (``deadline_ms``). :meth:`flush` packs the queue on the
    host into ``group``-sized groups (``microbatch``, or ``microbatch *
    n_microbatches`` with a ``mesh``; tail padded with zero frames,
    outputs sliced back per request), copies each group to the device and
    runs it through the active rung; with :meth:`start` (or
    ``auto_flush=True``, or the context manager) a background loop does
    this continuously. Admission control (``max_queue`` + ``admission``)
    blocks, rejects or sheds; gate validation fails non-finite or
    non-float frames at submit. Dispatch runs under a watchdog
    (``dispatch_timeout_s``), retries with exponential backoff
    (``max_retries``), and demotes (mesh ->) fused -> per_layer on
    persistent failure (``engine.demotions`` records why). A rung serves
    only after the plan passes its self-check and the rung completes a
    warmup probe, which on the card also captures the rung's CUDA graph
    (a capture that fails is a failed probe). ``donate`` stages each
    packed group into the graph's input buffer instead of a fresh device
    tensor.

    ``fault_plan`` injects deterministic failures
    (:mod:`repro_torch.core.dhm.faults`) for chaos testing.
    """

    def __init__(
        self,
        plan,
        *,
        name: Optional[str] = None,
        microbatch: int = 8,
        mesh=None,
        n_microbatches=4,  # int, or "auto" to run the µbatch autotuner
        data_axis: Optional[str] = None,
        stage_axis: str = "stage",
        overlap: bool = False,
        edge_mode: str = "auto",
        tuning=None,  # a throughput.PipelineTuning overriding the knobs
        donate: bool = True,
        warmup: bool = True,
        max_queue: int = 0,
        admission: str = "block",
        default_deadline_ms: Optional[float] = None,
        deadline_margin_ms: float = 2.0,
        validate: bool = True,
        check_outputs: bool = True,
        auto_flush: bool = False,
        flush_interval_ms: float = 5.0,
        dispatch_timeout_s: Optional[float] = 120.0,
        warmup_timeout_s: Optional[float] = None,
        max_retries: int = 2,
        retry_backoff_s: float = 0.005,
        allow_degraded: bool = True,
        fault_plan: Optional[FaultPlan] = None,
    ):
        # Autotuned pipeline geometry: an explicit PipelineTuning (from
        # throughput.autotune_pipeline over measured sweeps) or
        # n_microbatches="auto" (the model-priced grid) overrides
        # microbatch / n_microbatches / overlap / edge_mode.
        if tuning is None and n_microbatches == "auto":
            if mesh is None:
                raise ValueError('n_microbatches="auto" needs a mesh to tune for')
            from repro_torch.core.dhm.throughput import autotune_pipeline

            tuning = autotune_pipeline(plan, mesh.size)
        if tuning is not None:
            microbatch = tuning.microbatch
            n_microbatches = tuning.n_microbatches
            overlap = tuning.overlap
            edge_mode = tuning.edge_mode
        self.tuning = tuning
        if microbatch < 1:
            raise ValueError(f"microbatch must be >= 1, got {microbatch}")
        admission = admission.replace("-", "_")
        if admission not in ADMISSION_POLICIES:
            raise ValueError(
                f"unknown admission policy {admission!r}; expected one of "
                f"{ADMISSION_POLICIES}"
            )
        if max_queue < 0:
            raise ValueError("max_queue must be >= 0 (0 = unbounded)")
        if mesh is not None and (
            not isinstance(n_microbatches, int) or n_microbatches < 1
        ):
            raise ValueError(f"n_microbatches must be >= 1, got {n_microbatches}")
        self.plan = plan
        self.device = plan.device
        self.name = name
        self.microbatch = microbatch
        self.mesh = mesh
        self.n_microbatches = n_microbatches
        self.data_axis = data_axis
        self.stage_axis = stage_axis
        self.overlap = overlap
        self.edge_mode = edge_mode
        # Frames one dispatch consumes.
        self.group = microbatch if mesh is None else microbatch * n_microbatches
        self.donate = donate
        self.warmup = warmup
        self.max_queue = max_queue
        self.admission = admission
        self.default_deadline_ms = default_deadline_ms
        self.deadline_margin_ms = deadline_margin_ms
        self.validate = validate
        self.check_outputs = check_outputs
        self.flush_interval_ms = flush_interval_ms
        self.dispatch_timeout_s = dispatch_timeout_s
        self.warmup_timeout_s = warmup_timeout_s
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self._faults = fault_plan

        h, w = plan.topo.input_shape
        self._frame_shape = (h, w, plan.topo.input_channels)
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._flush_lock = threading.Lock()
        self._queue: list = []
        self._queue_frames = 0
        self._requests = 0
        self._requests_base = 0
        self._frames = 0
        self._batches = 0
        self._busy_s = 0.0
        self._lat_n = 0
        self._lat_sum = 0.0
        self._lat_max = 0.0
        self._rung_lat: dict = {}
        self._n_ok = 0
        self._n_rejected = 0
        self._n_shed = 0
        self._n_deadline = 0
        self._n_invalid = 0
        self._n_failed = 0
        self._n_retries = 0
        self.demotions: list = []
        self._flusher: Optional[threading.Thread] = None
        # A router's scheduler registers itself here (a zero-arg liveness
        # predicate): while it is alive the engine behaves as if a
        # background flusher runs — ``result()`` waits and block-policy
        # submits park on the condition instead of draining inline.
        self._external_flusher: Optional[Callable[[], bool]] = None
        self._stop = threading.Event()

        self._ladder: list = []
        if mesh is not None:
            self._ladder.append(("mesh", self._build_mesh_fwd))
        self._ladder.append(("fused", self._build_fused_fwd))
        if allow_degraded:
            self._ladder.append(("per_layer", self._build_unfused_fwd))
        plan.self_check()
        self._rung_idx = -1
        self._rung_name = ""
        self._fwd: Optional[Callable] = None
        if not self._activate_rung(0, reason=None):
            raise LadderExhausted(
                "no rung of the execution ladder passed its warmup probe"
            )
        if auto_flush:
            self.start()

    # -- execution ladder ---------------------------------------------------

    @property
    def rung(self) -> str:
        """Name of the ladder rung currently serving."""
        return self._rung_name

    def _build_fused_fwd(self) -> Callable:
        return plan_jitted_forward(self.plan, donate=self.donate)

    def _build_unfused_fwd(self) -> Callable:
        """The degraded closure: one single-layer kernel launch per conv
        layer (the ``vmem_budget=0`` lowering), same baked params and head,
        as a :class:`JittedForward` of its own with the engine's donation."""
        from repro_torch.core.dhm.compiler import emit_conv_stage

        plan = self.plan
        stage_fns = [
            emit_conv_stage(
                st.specs, block_r=plan.block_r,
                **plan.stage_quant_kwargs(st.index),
            )
            for st in plan.stages
        ]

        def _fwd(xb):
            for s, fn in enumerate(stage_fns):
                xb = fn(plan.stage_params(s), xb)
            return plan.head_fn(xb)

        return JittedForward(_fwd, plan.device, donate=self.donate)

    def _build_mesh_fwd(self) -> Callable:
        """The mesh rung (:func:`_mesh_forward`): on one card a
        :class:`JittedForward` with the engine's donation, captured in
        the rung's warmup probe at the group shape and replayed for every
        group after it."""
        from repro_torch.core.dhm.pipeline import PipelineConfig

        cfg = PipelineConfig(
            self.plan.n_stages, self.n_microbatches, stage_axis=self.stage_axis,
            data_axis=self.data_axis, overlap=self.overlap,
            edge_mode=self.edge_mode,
        )
        self._runner, fwd = _mesh_forward(
            self.plan, self.mesh, cfg, self.microbatch, donate=self.donate
        )
        return fwd

    def _activate_rung(self, idx: int, reason: Optional[str], cause=None) -> bool:
        """Walk the ladder from ``idx`` until a rung builds and passes its
        warmup probe; record every rung skipped or left as a demotion."""
        if reason is not None and self._rung_name:
            self.demotions.append(self._demotion_record(self._rung_name, cause or reason))
            _LOG.warning("engine demoting off rung %r: %s", self._rung_name, reason)
        while idx < len(self._ladder):
            name, factory = self._ladder[idx]
            try:
                fwd = factory()
                if self.warmup:
                    probe = np.zeros((self.group,) + self._frame_shape, np.float32)
                    watch = Watch()
                    out = call_with_timeout(
                        lambda: self._watched(watch, lambda: self._forward(fwd, probe)),
                        timeout_s=self.warmup_timeout_s,
                        what=f"warmup probe (rung {name})", watch=watch,
                    )
                    if not bool(torch.isfinite(out).all()):
                        raise _NonFiniteOutput(
                            f"rung {name} warmup probe produced non-finite logits"
                        )
            except Exception as e:  # noqa: BLE001 — any failure demotes
                self.demotions.append(self._demotion_record(name, e))
                _LOG.warning("engine rung %r failed its warmup probe: %s", name, e)
                idx += 1
                continue
            self._rung_idx = idx
            self._rung_name = name
            self._fwd = fwd
            return True
        return False

    @staticmethod
    def _demotion_record(rung: str, cause) -> dict:
        rec = {"rung": rung, "reason": str(cause)}
        ids = getattr(cause, "invariants", ())
        if ids:
            rec["invariants"] = list(ids)
        return rec

    def _demote(self, cause: BaseException) -> None:
        if not self._activate_rung(self._rung_idx + 1, reason=str(cause), cause=cause):
            raise LadderExhausted(
                f"every execution-ladder rung failed (last: {cause})"
            ) from cause

    # -- request queue + admission -------------------------------------------

    def submit(self, x, *, deadline_ms: Optional[float] = None) -> Request:
        """Enqueue a frame ((H, W, C)) or batch of frames ((B, H, W, C)) —
        a tensor or an array; returns a :class:`Request`. Malformed shapes
        raise ``ValueError``; non-finite or non-float frames fail the
        request with :class:`InvalidRequest`; a full queue is handled per
        the admission policy."""
        req = self._new_request(x, deadline_ms=deadline_ms)
        if req.done:
            return req
        return self._enqueue(req)

    def _new_request(self, x, *, deadline_ms: Optional[float] = None) -> Request:
        # Queued frames live on the HOST: the flush packs variable request
        # counts with numpy, and only the fixed-size packed group is copied
        # to the device.
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        x = np.asarray(x)
        if x.shape == self._frame_shape:
            x = x[None]
        if x.ndim != 4 or tuple(x.shape[1:]) != self._frame_shape:
            raise ValueError(
                f"expected frames of shape {self._frame_shape} (optionally "
                f"batched), got {tuple(x.shape)}"
            )
        now = time.perf_counter()
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        with self._lock:
            index = self._requests
            self._requests += 1
        req = Request(
            index=index, n_frames=x.shape[0], submitted_at=now,
            deadline_at=now + deadline_ms / 1e3 if deadline_ms is not None else None,
            _engine=self, _frames=x,
        )
        if self.validate:
            if not np.issubdtype(x.dtype, np.floating):
                self._fail(req, InvalidRequest(
                    f"request {req.index}: frames must be floating point, "
                    f"got dtype {x.dtype}"
                ))
            elif not bool(np.isfinite(x).all()):
                self._fail(req, InvalidRequest(
                    f"request {req.index}: frames contain NaN/Inf — rejected "
                    "at the admission gate"
                ))
        return req

    def _enqueue(self, req: Request) -> Request:
        while True:
            with self._cv:
                if not self.max_queue or len(self._queue) < self.max_queue:
                    self._queue.append(req)
                    self._queue_frames += req.n_frames
                    self._cv.notify_all()
                    return req
                if self.admission == "reject":
                    self._fail(req, Rejected(
                        f"request {req.index}: queue full ({self.max_queue} "
                        "requests), policy=reject"
                    ))
                    return req
                if self.admission == "shed_oldest":
                    victim = self._queue.pop(0)
                    self._queue_frames -= victim.n_frames
                    self._fail(victim, Shed(
                        f"request {victim.index}: shed by newer work (queue "
                        f"full at {self.max_queue} requests, policy=shed_oldest)"
                    ))
                    continue
                if self._flusher_alive():  # policy "block": wait for the flusher
                    self._cv.wait(timeout=0.05)
                    continue
            self.flush()  # ...or drain inline when no background flusher runs

    def _fail(self, req: Request, err: RequestError) -> None:
        """Complete a request with a structured error (exactly once)."""
        with self._lock:
            if req.done:
                return
            if isinstance(err, Shed):
                self._n_shed += 1
            elif isinstance(err, Rejected):
                self._n_rejected += 1
            elif isinstance(err, DeadlineExceeded):
                self._n_deadline += 1
            elif isinstance(err, InvalidRequest):
                self._n_invalid += 1
            else:
                self._n_failed += 1
            req._error = err
            req.done_at = time.perf_counter()
            req._frames = None
            req._event.set()

    def _complete(self, req: Request, logits: torch.Tensor, done: float) -> None:
        with self._lock:
            if req.done:
                return
            req._result = logits
            req.done_at = done
            req._frames = None
            req._event.set()
            lat = done - req.submitted_at
            self._lat_n += 1
            self._lat_sum += lat
            self._lat_max = max(self._lat_max, lat)
            self._rung_lat.setdefault(
                self._rung_name, collections.deque(maxlen=_LAT_WINDOW)
            ).append(lat)
            self._n_ok += 1
            self._frames += req.n_frames

    # -- dispatch: watchdog, retry, demotion ----------------------------------

    def _stage(self, batch: np.ndarray, fwd: Optional[Callable] = None) -> torch.Tensor:
        """Copy a packed host micro-batch to the device: into ``fwd``'s
        input buffer when the engine donates and ``fwd`` is a
        :class:`JittedForward` (the caller holds ``fwd.lock``), else into
        a fresh tensor."""
        host = torch.from_numpy(np.ascontiguousarray(batch, np.float32))
        if self.donate and isinstance(fwd, JittedForward):
            return fwd.input_buffer(host.shape).copy_(host)
        return host.to(self.device)

    def _forward(self, fwd: Callable, batch: np.ndarray) -> torch.Tensor:
        """Stage ``batch`` for ``fwd`` and run it, holding a graph
        closure's lock from the staging to its output copy."""
        if not isinstance(fwd, JittedForward):
            return fwd(self._stage(batch))
        with fwd.lock:
            return fwd(self._stage(batch, fwd))

    def _sync(self, out: torch.Tensor) -> torch.Tensor:
        """Wait for the device and bring the logits to the host."""
        return out.to("cpu")

    def _watched(self, watch: Watch, run: Callable[[], torch.Tensor]) -> torch.Tensor:
        """One attempt's launches: on the plan's device, and only if its
        watchdog has not given up on it (``watch``) by then."""
        with on_device(self.device):
            if not watch.claim():
                raise CollectiveTimeout("the watchdog gave up before the first launch")
            return self._sync(run())

    def _corrupted_forward(self, frames: np.ndarray, stage: int) -> torch.Tensor:
        """Forward with NaN corruption injected at the boundary after conv
        stage ``stage`` (the fault-injection path — models silent
        mid-pipeline data corruption)."""
        with torch.inference_mode():
            x = self._stage(frames)
            for st in self.plan.stages:
                x = st.fn(self.plan.stage_params(st.index), x)
                if st.index == stage:
                    x = torch.full_like(x, float("nan"))
            return self.plan.head_fn(x)

    def _attempt(self, frames: np.ndarray, eff, fwd: Callable,
                 watch: Watch) -> Callable[[], torch.Tensor]:
        """One dispatch attempt as a closure over its own fault effects,
        rung and watch: a worker abandoned by its watchdog that wakes after
        the engine has moved on still sees only these, never the next
        attempt's."""

        def _run():
            if eff is not None:
                if eff.stall_s:
                    watch.sleep(eff.stall_s)
                if eff.exc is not None:
                    raise eff.exc
                if eff.corrupt_stage is not None:
                    return self._watched(
                        watch, lambda: self._corrupted_forward(frames, eff.corrupt_stage)
                    )
            return self._watched(watch, lambda: self._forward(fwd, frames))

        return _run

    def _run_group(self, frames: np.ndarray) -> torch.Tensor:
        """Run one exactly-``group``-sized batch through the active rung:
        fault effects applied, watchdog timeout, bounded retry-with-backoff,
        demotion on persistent failure. Raises :class:`LadderExhausted` when
        no rung can complete the batch, :class:`_PoisonedBatch` when the
        inputs themselves are non-finite."""
        backoff = self.retry_backoff_s
        retries_left = self.max_retries
        while True:
            eff = (
                self._faults.dispatch_effects(rung=self._rung_name, tenant=self.name)
                if self._faults is not None
                else None
            )
            watch = Watch()
            try:
                out = call_with_timeout(
                    self._attempt(frames, eff, self._fwd, watch),
                    timeout_s=self.dispatch_timeout_s,
                    what=f"dispatch (rung {self._rung_name})",
                    watch=watch,
                )
                with self._lock:
                    self._batches += 1
                if self.check_outputs and not bool(torch.isfinite(out).all()):
                    if not bool(np.isfinite(frames).all()):
                        raise _PoisonedBatch("packed batch carries non-finite input frames")
                    raise _NonFiniteOutput(
                        f"rung {self._rung_name} produced non-finite logits "
                        "from finite inputs"
                    )
                return out
            except _PoisonedBatch:
                raise
            except (InjectedDeviceLoss, CollectiveTimeout) as e:
                # Not transient: a lost device or a wedged dispatch will not
                # heal on retry — demote off the rung now.
                self._demote(e)
                retries_left = self.max_retries
                backoff = self.retry_backoff_s
            except Exception as e:  # noqa: BLE001 — retry then demote
                if retries_left > 0:
                    retries_left -= 1
                    with self._lock:
                        self._n_retries += 1
                    _LOG.info(
                        "dispatch failed on rung %r (%s); retrying in %.3fs "
                        "(%d retries left)", self._rung_name, e, backoff,
                        retries_left,
                    )
                    time.sleep(backoff)
                    backoff *= 2
                else:
                    self._demote(e)
                    retries_left = self.max_retries
                    backoff = self.retry_backoff_s

    # -- flushing -------------------------------------------------------------

    def flush(self, max_frames: Optional[int] = None) -> int:
        """Drain the queue: pack pending frames into ``group``-sized
        micro-batches (zero-padded tail), run each through the active
        rung, and scatter the logits back to their requests. Expired
        deadlines complete with :class:`DeadlineExceeded` at pack time.
        A no-op on an empty queue; thread-safe against the background
        flusher. ``max_frames`` bounds one call to about that many frames
        from the queue head (always at least one request). Returns the
        number of frames taken off the queue."""
        with self._flush_lock:
            return self._flush_once(max_frames)

    def _flush_once(self, max_frames: Optional[int] = None) -> int:
        if self._faults is not None:
            delay = self._faults.on_flush(tenant=self.name)
            if delay:
                time.sleep(delay)
        with self._cv:
            if not self._queue:
                return 0
            if max_frames is None:
                pending, self._queue = self._queue, []
                self._queue_frames = 0
            else:
                pending, taken = [], 0
                while self._queue and (
                    not pending or taken + self._queue[0].n_frames <= max_frames
                ):
                    r = self._queue.pop(0)
                    pending.append(r)
                    taken += r.n_frames
                self._queue_frames -= taken
            self._cv.notify_all()
        n_taken = sum(r.n_frames for r in pending)
        t0 = time.perf_counter()
        live = []
        for req in pending:
            if req.deadline_at is not None and t0 > req.deadline_at:
                self._fail(req, DeadlineExceeded(
                    f"request {req.index}: deadline passed "
                    f"{(t0 - req.deadline_at) * 1e3:.1f} ms before dispatch"
                ))
            else:
                live.append(req)
        if not live:
            return n_taken
        try:
            frames = np.concatenate([r._frames for r in live], axis=0)
            n = frames.shape[0]
            pad = -n % self.group
            if pad:
                frames = np.concatenate(
                    [frames, np.zeros((pad,) + self._frame_shape, frames.dtype)]
                )
            outs = [
                self._run_group(frames[start : start + self.group])
                for start in range(0, frames.shape[0], self.group)
            ]
            logits = _pack_logits(outs, n)
        except _PoisonedBatch:
            self._isolate(live)
            with self._lock:
                self._busy_s += time.perf_counter() - t0
            return n_taken
        except LadderExhausted as e:
            for req in live:
                self._fail(req, BatchFailed(f"request {req.index}: batch failed — {e}"))
            with self._lock:
                self._busy_s += time.perf_counter() - t0
            return n_taken
        except Exception as e:  # noqa: BLE001 — never drop requests silently
            _LOG.exception("unexpected flush failure")
            for req in live:
                self._fail(req, BatchFailed(
                    f"request {req.index}: unexpected flush failure — "
                    f"{type(e).__name__}: {e}"
                ))
            with self._lock:
                self._busy_s += time.perf_counter() - t0
            return n_taken
        done = time.perf_counter()
        off = 0
        for req in live:
            self._complete(req, logits[off : off + req.n_frames], done)
            off += req.n_frames
        with self._lock:
            self._busy_s += done - t0
        return n_taken

    def _isolate(self, reqs: list) -> None:
        """Rerun a poisoned batch one request at a time: invalid requests
        fail alone, the rest recompute cleanly."""
        for req in reqs:
            x = req._frames
            if not bool(np.isfinite(x).all()):
                self._fail(req, InvalidRequest(
                    f"request {req.index}: frames contain NaN/Inf — isolated "
                    "from its batch"
                ))
                continue
            pad = -req.n_frames % self.group
            if pad:
                x = np.concatenate([x, np.zeros((pad,) + self._frame_shape, x.dtype)])
            try:
                outs = [
                    self._run_group(x[start : start + self.group])
                    for start in range(0, x.shape[0], self.group)
                ]
            except (LadderExhausted, _PoisonedBatch) as e:
                self._fail(req, BatchFailed(
                    f"request {req.index}: isolated rerun failed — {e}"
                ))
                continue
            self._complete(req, _pack_logits(outs, req.n_frames), time.perf_counter())

    # -- background flush loop ------------------------------------------------

    def _flusher_alive(self) -> bool:
        if self._flusher is not None and self._flusher.is_alive():
            return True
        ext = self._external_flusher
        return bool(ext is not None and ext())

    def start(self) -> "Engine":
        """Start the background flush loop (idempotent): micro-batches go
        out when they fill, when the earliest queued deadline is within
        ``deadline_margin_ms``, or every ``flush_interval_ms``."""
        if self._flusher_alive():
            return self
        self._stop = threading.Event()
        self._flusher = threading.Thread(
            target=self._flush_loop, daemon=True, name="dhm-engine-flusher"
        )
        self._flusher.start()
        return self

    def _shed_all(self, why: str) -> int:
        with self._cv:
            pending, self._queue = self._queue, []
            self._queue_frames = 0
            self._cv.notify_all()
        for req in pending:
            self._fail(req, Shed(f"request {req.index}: {why}"))
        return len(pending)

    def stop(self, *, drain: bool = True, join_timeout_s: float = 30.0) -> None:
        """Stop the background flush loop; by default drain what is still
        queued. If the flusher does not exit within ``join_timeout_s``,
        every still-queued request completes with :class:`Shed` and
        :class:`FlusherWedged` is raised."""
        flusher = self._flusher
        if flusher is not None:
            self._stop.set()
            with self._cv:
                self._cv.notify_all()
            flusher.join(timeout=join_timeout_s)
            self._flusher = None
            if flusher.is_alive():
                shed = self._shed_all("engine stopping with a wedged flush thread")
                raise FlusherWedged(
                    f"flush thread did not exit within {join_timeout_s:.1f}s "
                    f"of stop(); {shed} queued request(s) completed with Shed"
                )
        if drain:
            self.flush()

    def __enter__(self) -> "Engine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _flush_loop(self) -> None:
        interval = self.flush_interval_ms / 1e3
        margin = self.deadline_margin_ms / 1e3
        last_flush = time.perf_counter()
        while not self._stop.is_set():
            with self._cv:
                if not self._queue:
                    self._cv.wait(timeout=interval)
                    continue
                full = self._queue_frames >= self.group
                ddl = min(
                    (r.deadline_at for r in self._queue if r.deadline_at is not None),
                    default=None,
                )
            now = time.perf_counter()
            if full or (ddl is not None and now >= ddl - margin) or (
                now - last_flush >= interval
            ):
                try:
                    self.flush()
                except Exception:  # noqa: BLE001 — the loop must survive
                    _LOG.exception("background flush failed; loop continues")
                last_flush = time.perf_counter()
            else:
                wait = interval - (now - last_flush)
                if ddl is not None:
                    wait = min(wait, ddl - margin - now)
                with self._cv:
                    self._cv.wait(timeout=max(1e-4, wait))
        try:
            self.flush()
        except Exception:  # noqa: BLE001
            _LOG.exception("final drain flush failed")

    # -- conveniences ----------------------------------------------------------

    def infer(self, x, *, deadline_ms: Optional[float] = None) -> torch.Tensor:
        """Convenience: submit + flush + result."""
        req = self.submit(x, deadline_ms=deadline_ms)
        if not self._flusher_alive():
            self.flush()
        return req.result()

    def stats(self) -> EngineStats:
        with self._lock:
            return EngineStats(
                n_requests=self._requests - self._requests_base,
                n_frames=self._frames,
                n_batches=self._batches,
                busy_s=self._busy_s,
                mean_latency_s=self._lat_sum / self._lat_n if self._lat_n else 0.0,
                max_latency_s=self._lat_max,
                n_ok=self._n_ok,
                n_rejected=self._n_rejected,
                n_shed=self._n_shed,
                n_deadline_exceeded=self._n_deadline,
                n_invalid=self._n_invalid,
                n_failed=self._n_failed,
                n_retries=self._n_retries,
                n_demotions=len(self.demotions),
                rung=self._rung_name,
                rung_latency_ms={
                    rung: {
                        "p50_ms": _percentile_ms(lat, 50.0),
                        "p99_ms": _percentile_ms(lat, 99.0),
                        "n": len(lat),
                    }
                    for rung, lat in self._rung_lat.items()
                },
            )

    def reset_stats(self) -> None:
        """Zero every counter and latency reservoir (the demotion ledger,
        the queue and the rung are kept)."""
        with self._lock:
            self._requests_base = self._requests
            self._frames = 0
            self._batches = 0
            self._busy_s = 0.0
            self._lat_n = 0
            self._lat_sum = 0.0
            self._lat_max = 0.0
            self._rung_lat = {}
            self._n_ok = 0
            self._n_rejected = 0
            self._n_shed = 0
            self._n_deadline = 0
            self._n_invalid = 0
            self._n_failed = 0
            self._n_retries = 0
