"""Quantization-aware training steps through ``jit_train_step``.

Set-up makes the weights and a train set of ``n_train_per_class`` frames a
class on the device from the seed, builds the jitted train step and its
AdamW state, and drives that one object through its first
``checked_steps`` steps (the first call captures the step's CUDA graph):
the steps the reference follows. Batches are gathered on the device, rows
from a seeded device ``randperm`` a pass over the set, so the checked
steps' rows all differ.

Set-up then runs the same loop as the window for the mix's
``warmup_seconds`` (the card runs the step slower for its first seconds in
a process). The window continues the same object from there: each step a
gather and a call, at most ``depth`` steps in flight (the host waits on
the event of the step ``depth`` back), no host read of a loss. It ends,
after ``seconds``, in a synchronise. ``train_frames_per_s`` is the
window's steps times the batch over the whole window.
"""
from __future__ import annotations

import collections
import gc
import time

import torch

from bench import inputs, program
from bench.cell import Outcome, Readings
from bench.correct import train_values
from bench.reference import cnn as reference
from bench.trace import Tracer


class _Batches:
    """Row indices on the device: a seeded ``randperm`` of the set a pass,
    cut into batches (a pass's remainder dropped)."""

    def __init__(self, n: int, batch: int, seed: int, device):
        self.n, self.batch, self.device = n, batch, device
        self.gen = inputs.generator(seed, device)
        self.perm, self.at = None, n

    def next(self) -> torch.Tensor:
        if self.at + self.batch > self.n:
            self.perm = torch.randperm(self.n, generator=self.gen, device=self.device)
            self.at = 0
        idx = self.perm[self.at:self.at + self.batch]
        self.at += self.batch
        return idx


def make_inputs(cell) -> tuple:
    """The cell's float weights, its train set (frames, labels) and its
    stream of batches' rows, from the seed."""
    cfg, dev = cell.config, cell.device
    topo = cfg["topology"]
    s_weights, s_frames, s_rows = inputs.sub_seeds(cell.seed)[:3]
    params0 = inputs.make_params(topo, cfg["init"], s_weights, dev)
    n = cell.size("n_train_per_class") * cfg["frames"]["n_classes"]
    x_all, y_all = inputs.make_frames(topo, cfg["frames"], n, s_frames, dev)
    return params0, x_all, y_all, _Batches(n, cell.size("batch"), s_rows, dev)


def run(cell) -> Outcome:
    cfg, mix, dev = cell.config, cell.mix, cell.device
    batch = cell.size("batch")
    n_checked = mix["checked_steps"]
    params0, x_all, y_all, rows = make_inputs(cell)
    step_fn, opt_init = program.train_step(cfg, mix)
    params = {g: [{k: t.clone() for k, t in p.items()} for p in ps] for g, ps in params0.items()}
    state = opt_init(params)

    checked_idx, losses, m1 = [], [], None
    for k in range(n_checked):
        idx = rows.next()
        checked_idx.append(idx)
        params, state, loss, _ = step_fn(params, state, x_all[idx], y_all[idx], k)
        losses.append(loss)
        if k == 0:
            m1 = state.m
    after = params

    def steps_for(seconds: float, tracer, first: int) -> tuple:
        """Steps from ``first`` for ``seconds``, at most ``depth`` in flight,
        then a synchronise: (steps, the host seconds of each call, window
        seconds)."""
        nonlocal params, state
        host, inflight = [], collections.deque()
        step = first
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            if len(inflight) >= mix["depth"]:
                with tracer.span("bench.wait"):
                    inflight.popleft().synchronize()
            with tracer.span("bench.batch"):
                idx = rows.next()
                x, y = x_all[idx], y_all[idx]
            with tracer.span("bench.step"):
                t_call = time.perf_counter()
                params, state, _, _ = step_fn(params, state, x, y, step)
                host.append(time.perf_counter() - t_call)
            if cell.on_card:
                event = torch.cuda.Event()
                event.record()
                inflight.append(event)
            step += 1
        with tracer.span("bench.wait"):
            cell.sync()
        return step - first, host, time.perf_counter() - t0

    warm, _, _ = steps_for(cell.size("warmup_seconds"), Tracer(False), n_checked)
    setup_s = cell.setup_s()
    with Tracer(cell.trace) as tracer:
        steps, host_s, window_s = steps_for(cell.seconds, tracer, n_checked + warm)
    memory_peak = torch.cuda.max_memory_allocated(dev) if cell.on_card else 0

    e2e = {"train_frames_per_s": steps * batch / window_s, "setup_s": setup_s}
    work = {"steps": steps, "batch": batch, "window_s": window_s}
    readings = Readings(cell=cell, trace=tracer.trace, host_s={"step": host_s}, work=work,
                        peaks={})

    prog = {
        "losses": [float(t) for t in losses],
        "m1": [t.detach().cpu() for t in reference.leaves(m1)],
        "params": [t.detach().cpu() for t in reference.leaves(after)],
    }
    batches = [(x_all[i], y_all[i]) for i in checked_idx]
    del step_fn, params, state, after, m1
    gc.collect()
    if cell.on_card:
        torch.cuda.empty_cache()
    ref = reference.qat_steps(cfg, mix, params0, batches)
    values = train_values(prog, ref, reference.leaves(params0))
    return Outcome(e2e=e2e, readings=readings, values=values, attempted=steps, failed=0,
                   memory_peak_bytes=memory_peak)
