"""Batch classification through a VGG configuration's int8 plan: the
client, window and inputs of :mod:`bench.loops.infer_requests`, with the
head's activation taken from the configuration and a check that holds
float32 head sums to a limit.

Set-up first builds the port's topology with the configuration's
``fc_act``, before any weights or frames are made: a program without a
head activation fails here, within seconds. It then makes the weights and
the pool from the seed, compiles the plan at the configuration's inference
quant mode, sends every pool batch through it once (the first call
captures the plan's CUDA graph) and runs the client for the mix's
``warmup_seconds``. The window is ``infer_requests``' own: one client,
``depth`` requests in flight, pool batches round-robin, each request's
logits copied into pinned host memory.

``work`` gains ``fused_i8_layers``: the conv layers that the plan's launch
table (``CompiledDHM.launch_table``, the one its graph's capture record
keeps) sends to the single-layer int8 kernel. A program without the table
gives none.

The check, after the window, on the pool batches of the kept requests
(one in ``sample_every``, and the last), with the program's state freed
before the reference runs (``bench/reference/vgg.py``):

- ``feature_codes_off``: stream codes of the plan's conv features
  (``CompiledDHM.features``, eager, on the batch) that differ from the
  reference's exact integer conv stage. Limit 0: the int8 conv is exact.
- ``logit_gap``: of each kept request's logits, as they reached the host,
  the largest |program - reference| of a frame over the largest
  |reference| of that frame, the worst frame of all. NaN never passes.
- ``requests_unanswered``: requests issued in the window whose logits
  never arrived.

On the CPU (the tests) the loop takes at most ``CPU_MACS`` conv MACs a
request and refuses more: VGG-16 at 224x224 runs on a card.
"""
from __future__ import annotations

import dataclasses
import gc
import math

import numpy as np
import torch

from bench import inputs, program
from bench.cell import Outcome, Readings
from bench.count import cnn as count
from bench.loops import infer_requests
from bench.reference import vgg as reference
from bench.trace import Tracer

CPU_MACS = 2e10  # conv MACs a request the loop runs on the CPU
FUSED_I8 = "stream_conv_fused_int8"


def topology(cfg: dict):
    """The port's ``CNNTopology`` of the configuration, with its head
    activation."""
    return dataclasses.replace(program.topology(cfg["topology"]),
                               fc_act=cfg["topology"]["fc_act"])


def compile_plan(topo, cfg: dict, params: dict, device):
    from repro_torch.core.dhm.compiler import QuantSpec, compile_dhm

    return compile_dhm(topo, params, quant=QuantSpec(**cfg["infer_quant"]), device=device)


def fused_i8_layers(plan) -> list:
    """The conv layers the plan's launch table sends to the single-layer
    int8 kernel; [] without a table."""
    return [li for e in getattr(plan, "launch_table", ()) if e.kernel == FUSED_I8
            for li in e.layers]


def codes_off(prog: torch.Tensor, ref: torch.Tensor) -> int:
    """Elements of the program's features not equal to the reference's
    (NaN never is)."""
    return int((prog.to(ref.device, torch.float64) != ref).sum())


def logit_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst frame's max |prog - ref| over its max |ref|; NaN where a
    logit is NaN."""
    prog = prog.to(ref.device, torch.float32)
    return float(((prog - ref).abs().amax(dim=1) / ref.abs().amax(dim=1)).max())


def check_size(cell) -> None:
    macs = count.conv_macs(cell.config["topology"]) * cell.size("frames_per_request")
    if not cell.on_card and macs > CPU_MACS:
        raise RuntimeError(
            f"{cell.name}: {macs:.3g} conv MACs a request is more than the CPU runs "
            f"({CPU_MACS:.0e}); this cell runs on a card")


def run(cell) -> Outcome:
    cfg, dev = cell.config, cell.device
    topo = topology(cfg)
    check_size(cell)
    params, pool = infer_requests.make_inputs(cell)
    per_req = pool.shape[1]
    plan = compile_plan(topo, cfg, params, dev)
    for k in range(pool.shape[0]):
        plan(pool[k])
    client = infer_requests._Client(cell, plan, pool)
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
    work = {"requests": issued, "frames_per_request": per_req, "window_s": window_s}
    layers = fused_i8_layers(plan)
    if layers:
        work["fused_i8_layers"] = layers
    readings = Readings(cell=cell, trace=tracer.trace, host_s={"enqueue": enqueue_s},
                        work=work, peaks={})

    batches = sorted({b for b, _ in kept})
    with torch.no_grad():
        feats = {k: plan.features(pool[k]) for k in batches}
    # The program's state goes before the reference runs.
    del plan, client
    gc.collect()
    if cell.on_card:
        torch.cuda.empty_cache()
    off, gaps = 0, []
    for k in batches:
        ref_feats = reference.features(cfg, params, pool[k])
        off += codes_off(feats.pop(k), ref_feats)
        ref = reference.head(cfg, params, ref_feats)
        gaps += [logit_gap(logits, ref) for b, logits in kept if b == k]
    gap = math.nan if any(math.isnan(g) for g in gaps) else max(gaps, default=0.0)
    unanswered = issued - len(latencies)
    values = {"feature_codes_off": off, "logit_gap": gap, "requests_unanswered": unanswered}
    return Outcome(e2e=e2e, readings=readings, values=values, attempted=issued,
                   failed=unanswered, memory_peak_bytes=memory_peak)
