"""Batch classification: requests of frames already on the device through
the compiled plan's ``__call__``, a closed loop of one client.

Set-up makes the weights and a pool of ``pool_batches`` distinct batches
of ``frames_per_request`` frames from the seed, compiles the plan at the
configuration's inference quant mode and sends every pool batch through it
once (the first call captures the plan's CUDA graph for the shape).

The window: the client issues request i with pool batch i mod
``pool_batches`` (``plan(x)``, then the logits' copy into pinned host
memory and an event), keeping ``depth`` requests in flight; when it has
``depth`` it waits for the oldest. A request completes when its logits
are on the host: its latency runs from its issue to then. No request is
issued after ``seconds``; the window ends when the last one completes.
``infer_frames_per_s`` is every issued frame over the whole window. Set-up
ends with the same client running for the mix's ``warmup_seconds``: the
card runs the window's work slower for its first seconds in a process.

The logits of the requests a seeded draw keeps (one in ``sample_every``,
and the last) are copied aside; after the window the reference computes
each pool batch once and every kept request is compared with it.
"""
from __future__ import annotations

import collections
import gc
import time

import numpy as np
import torch

from bench import inputs, program
from bench.cell import Outcome, Readings
from bench.correct import frames_outside
from bench.reference import cnn as reference
from bench.trace import Tracer


class _Request:
    __slots__ = ("batch", "slot", "t_issue", "event")

    def __init__(self, batch, slot, t_issue, event):
        self.batch, self.slot, self.t_issue, self.event = batch, slot, t_issue, event


class _Client:
    """One client of the plan: issues pool batches round-robin, ``depth`` in
    flight, each request's logits copied into pinned host memory."""

    def __init__(self, cell, plan, pool):
        self.cell, self.plan, self.pool = cell, plan, pool
        self.depth = cell.mix["depth"]
        shape = (pool.shape[1], cell.config["topology"]["n_classes"])
        self.host = [torch.empty(shape, dtype=torch.float32, pin_memory=cell.on_card)
                     for _ in range(self.depth)]

    def run(self, seconds: float, tracer, done=None) -> tuple:
        """Issue requests for ``seconds``, then wait for the last. Calls
        ``done(request, latency)`` as each completes (its logits in
        ``self.host[request.slot]`` until the next request reuses the slot).
        Returns (requests issued, the host seconds of each ``plan`` call,
        window seconds)."""
        on_card, n_pool = self.cell.on_card, self.pool.shape[0]
        enqueue_s = []
        inflight: collections.deque = collections.deque()
        issued = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            while len(inflight) < self.depth and time.perf_counter() < deadline:
                slot = issued % self.depth
                with tracer.span("bench.enqueue"):
                    t_issue = time.perf_counter()
                    logits = self.plan(self.pool[issued % n_pool])
                    enqueue_s.append(time.perf_counter() - t_issue)
                with tracer.span("bench.to_host"):
                    self.host[slot].copy_(logits, non_blocking=on_card)
                    event = torch.cuda.Event() if on_card else None
                    if event is not None:
                        event.record()
                inflight.append(_Request(issued % n_pool, slot, t_issue, event))
                issued += 1
            if not inflight:
                break
            req = inflight.popleft()
            with tracer.span("bench.wait"):
                if req.event is not None:
                    req.event.synchronize()
                t_done = time.perf_counter()
            if done is not None:
                done(req, t_done - req.t_issue, not inflight and t_done >= deadline)
        return issued, enqueue_s, time.perf_counter() - t0


def make_inputs(cell) -> tuple:
    """The cell's float weights and its pool, (pool_batches,
    frames_per_request, H, W, C), from the seed."""
    topo = cell.config["topology"]
    per_req, n_pool = cell.size("frames_per_request"), cell.size("pool_batches")
    s_weights, s_frames = inputs.sub_seeds(cell.seed)[:2]
    params = inputs.make_params(topo, cell.config["init"], s_weights, cell.device)
    frames, _ = inputs.make_frames(topo, cell.config["frames"], n_pool * per_req, s_frames,
                                   cell.device)
    return params, frames.view(n_pool, per_req, *frames.shape[1:])


def run(cell) -> Outcome:
    cfg, dev = cell.config, cell.device
    params, pool = make_inputs(cell)
    per_req = pool.shape[1]
    plan = program.compile_plan(cfg, params, dev)
    for k in range(pool.shape[0]):
        plan(pool[k])
    client = _Client(cell, plan, pool)
    client.run(cell.size("warmup_seconds"), Tracer(False))
    sampler = np.random.default_rng(inputs.sub_seeds(cell.seed)[2])
    every = cell.mix["sample_every"]
    cell.sync()
    setup_s = cell.setup_s()

    kept, latencies = [], []

    def done(req, latency, last):
        latencies.append(latency)
        if sampler.random() < 1.0 / every or last:
            kept.append((req.batch, client.host[req.slot].clone()))

    with Tracer(cell.trace) as tracer:
        issued, enqueue_s, window_s = client.run(cell.seconds, tracer, done)
    memory_peak = torch.cuda.max_memory_allocated(dev) if cell.on_card else 0

    e2e = {
        "infer_frames_per_s": issued * per_req / window_s,
        "infer_p95_ms": 1e3 * float(np.percentile(latencies, 95)),
        "setup_s": setup_s,
    }
    traced = tracer.trace
    work = {"requests": issued, "frames_per_request": per_req, "window_s": window_s}
    readings = Readings(cell=cell, trace=traced, host_s={"enqueue": enqueue_s}, work=work,
                        peaks={})

    # The program's state goes before the reference runs.
    del plan, client
    gc.collect()
    if cell.on_card:
        torch.cuda.empty_cache()
    outside = 0
    for k in sorted({b for b, _ in kept}):
        ref = reference.int8_forward(cfg, params, pool[k])
        outside += sum(frames_outside(logits, ref) for b, logits in kept if b == k)
    values = {"frames_outside": outside, "requests_unanswered": issued - len(latencies)}
    return Outcome(e2e=e2e, readings=readings, values=values, attempted=issued,
                   failed=issued - len(latencies), memory_peak_bytes=memory_peak)
