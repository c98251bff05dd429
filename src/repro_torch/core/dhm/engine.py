"""Execution + serving for compiled DHM plans (single device).

The counterpart of ``repro.core.dhm.engine``:

- :func:`forward` — the eager stage/head composition on the plan's device.
- :class:`Engine` — the fault-tolerant continuous-batching server.
  Requests carry per-request deadlines (``submit(x, deadline_ms=...)``);
  a background flush loop packs a micro-batch when it fills *or* the
  earliest deadline approaches; admission control bounds the queue
  (``block | reject | shed_oldest``) and validates every frame at the
  gate; dispatch runs under a watchdog timeout with bounded
  retry-with-backoff; persistent failures demote the engine down a
  health-checked ladder (fused plan -> per-layer plan). Both rungs run
  the plan's kernels; there is no plain-version rung on the card.
  Failures surface as structured per-request errors — ``result()``
  raises, it never hangs.

The mesh rung, the µbatch autotuner and fault injection are later slices
of the port.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.dhm.pipeline import CollectiveTimeout, call_with_timeout

_LOG = logging.getLogger("repro_torch.dhm.engine")


def forward(plan, x: torch.Tensor) -> torch.Tensor:
    """Eager single-device forward: sequential fused stages + FC head.
    x: (B, H, W, C) NHWC on the plan's device -> logits (B, n_classes)."""
    return plan.head_fn(plan.features(x))


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
    host into ``microbatch``-sized groups (tail padded with zero frames,
    outputs sliced back per request), copies each group to the device and
    runs it through the active rung; with :meth:`start` (or
    ``auto_flush=True``, or the context manager) a background loop does
    this continuously. Admission control (``max_queue`` + ``admission``)
    blocks, rejects or sheds; gate validation fails non-finite or
    non-float frames at submit. Dispatch runs under a watchdog
    (``dispatch_timeout_s``), retries with exponential backoff
    (``max_retries``), and demotes fused -> per_layer on persistent
    failure (``engine.demotions`` records why). A rung serves only after
    the plan passes its self-check and the rung completes a warmup probe.
    """

    def __init__(
        self,
        plan,
        *,
        name: Optional[str] = None,
        microbatch: int = 8,
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
    ):
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
        self.plan = plan
        self.device = plan.device
        self.name = name
        self.microbatch = microbatch
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
        self._stop = threading.Event()

        self._ladder: list = [("fused", self._build_fused_fwd)]
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
        plan = self.plan

        def _fwd(xb):
            with torch.inference_mode():
                return forward(plan, xb)

        return _fwd

    def _build_unfused_fwd(self) -> Callable:
        """The degraded closure: one single-layer kernel launch per conv
        layer (the ``vmem_budget=0`` lowering), same baked params and head."""
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
            with torch.inference_mode():
                for s, fn in enumerate(stage_fns):
                    xb = fn(plan.stage_params(s), xb)
                return plan.head_fn(xb)

        return _fwd

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
                    probe = np.zeros((self.microbatch,) + self._frame_shape, np.float32)
                    out = call_with_timeout(
                        lambda: self._sync(fwd(self._stage(probe))),
                        timeout_s=self.warmup_timeout_s,
                        what=f"warmup probe (rung {name})",
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

    def _stage(self, batch: np.ndarray) -> torch.Tensor:
        """Copy a packed host micro-batch into a fresh device tensor."""
        return torch.from_numpy(np.ascontiguousarray(batch, np.float32)).to(self.device)

    def _sync(self, out: torch.Tensor) -> torch.Tensor:
        """Wait for the device and bring the logits to the host."""
        return out.to("cpu")

    def _run_group(self, frames: np.ndarray) -> torch.Tensor:
        """Run one exactly-``microbatch``-sized batch through the active rung:
        watchdog timeout, bounded retry-with-backoff, demotion on
        persistent failure. Raises :class:`LadderExhausted` when no rung
        can complete the batch, :class:`_PoisonedBatch` when the inputs
        themselves are non-finite."""
        backoff = self.retry_backoff_s
        retries_left = self.max_retries
        while True:
            try:
                out = call_with_timeout(
                    lambda: self._sync(self._fwd(self._stage(frames))),
                    timeout_s=self.dispatch_timeout_s,
                    what=f"dispatch (rung {self._rung_name})",
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
            except CollectiveTimeout as e:
                # A wedged dispatch will not heal on retry: demote now.
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
        """Drain the queue: pack pending frames into ``microbatch``-sized
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
            pad = -n % self.microbatch
            if pad:
                frames = np.concatenate(
                    [frames, np.zeros((pad,) + self._frame_shape, frames.dtype)]
                )
            outs = [
                self._run_group(frames[start : start + self.microbatch])
                for start in range(0, frames.shape[0], self.microbatch)
            ]
            logits = torch.cat(outs, dim=0)[:n]
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
            pad = -req.n_frames % self.microbatch
            if pad:
                x = np.concatenate([x, np.zeros((pad,) + self._frame_shape, x.dtype)])
            try:
                outs = [
                    self._run_group(x[start : start + self.microbatch])
                    for start in range(0, x.shape[0], self.microbatch)
                ]
            except (LadderExhausted, _PoisonedBatch) as e:
                self._fail(req, BatchFailed(
                    f"request {req.index}: isolated rerun failed — {e}"
                ))
                continue
            self._complete(req, torch.cat(outs)[: req.n_frames], time.perf_counter())

    # -- background flush loop ------------------------------------------------

    def _flusher_alive(self) -> bool:
        return self._flusher is not None and self._flusher.is_alive()

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
                full = self._queue_frames >= self.microbatch
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
