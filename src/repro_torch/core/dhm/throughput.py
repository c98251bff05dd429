"""DHM throughput models: the paper's FPGA streaming law (Table 4) and
the spatial-pipeline cost model + measurement-driven µbatch autotuner.

The counterpart of ``repro.core.dhm.throughput``, pure Python and held
for equality with it.

FPGA law (paper Table 4). With full pipelining the accelerator ingests
one input *sample* (one pixel of one channel of the streamed frame) per
clock cycle, and every mapped operation fires once per ingested frame:

    throughput [op/s] = f_clk * ops_per_frame / (H * W * C_in)

:func:`dhm_throughput_gops` gives the paper's Table 4 rows (LeNet5 at
65.71 MHz, Cifar10 at 63.89 MHz, SVHN on the Zynq at 54.17 MHz): FPGA
numbers of the paper, not of this port.

The same law for the GPipe spatial pipeline of ``pipeline.py``:
steady-state throughput is bounded by the slowest stage's per-tick time,
fill/drain ticks dilute it by the bubble fraction, and each tick also
pays the interior-edge traffic (sized by
:func:`repro_torch.core.dhm.pipeline.plan_edges`: exact-shape classes,
not the max box) plus a fixed dispatch overhead. :func:`estimate_pipeline`
prices a (n_microbatches, batch grain, data split, overlap) configuration
with three machine constants (effective FLOP/s, effective edge bytes/s,
per-tick overhead), which :func:`fit_constants` recovers from measured
sweep rows by least squares. :func:`autotune_pipeline` searches the
candidate grid; measured sweep points outrank model estimates.

The default constants (:class:`PipelineCostConstants`) are the
reference's round host-CPU-mesh numbers, kept for parity with it. They
are not the card's: on the card the tuner is fed measured rows (phase 6
of ``chip_smoke.py`` sweeps the pipeline with CUDA events and fits the
constants from them).
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class ThroughputReport:
    name: str
    workload_mop: float  # ops per frame (feature extractor)
    f_clk_mhz: float
    gops: float
    frames_per_s: float

    def summary(self) -> str:
        return (
            f"{self.name:>10s}: {self.workload_mop:6.1f} Mop @ "
            f"{self.f_clk_mhz:6.2f} MHz -> {self.gops:7.2f} Gop/s "
            f"({self.frames_per_s:9.1f} frames/s)"
        )


def streaming_throughput(
    ops_per_frame: float, samples_per_frame: float, f_clk_hz: float
) -> tuple:
    """The paper's streaming law: a fully-pipelined dataflow graph ingests
    one sample per clock, so every mapped op fires once per frame.

    Returns ``(op_per_s, frames_per_s)``.
    """
    frames = f_clk_hz / samples_per_frame
    return ops_per_frame * frames, frames


def dhm_throughput_gops(topo, f_clk_mhz: float) -> ThroughputReport:
    """Throughput of a DHM-mapped feature extractor at a clock frequency
    (thin wrapper over :func:`streaming_throughput` — the paper's Table 4
    formula, unchanged)."""
    ops = topo.feature_extractor_ops()
    h_in, w_in = topo.input_shape
    samples = h_in * w_in * topo.input_channels
    op_per_s, frames = streaming_throughput(ops, samples, f_clk_mhz * 1e6)
    return ThroughputReport(
        name=topo.name,
        workload_mop=ops / 1e6,
        f_clk_mhz=f_clk_mhz,
        gops=op_per_s / 1e9,
        frames_per_s=frames,
    )


# ---------------------------------------------------------------------------
# Spatial-pipeline cost model.


@dataclasses.dataclass(frozen=True)
class PipelineCostConstants:
    """The three machine constants the pipeline model prices ticks with:
    effective per-device FLOP/s on stage bodies, effective edge bytes/s
    between slots, and fixed per-tick overhead (the host's launches and
    the edges' events). Defaults are the reference's round host-CPU-mesh numbers,
    kept for parity and never the card's; :func:`fit_constants` replaces
    them with least-squares values from measured sweeps."""

    flops_per_s: float = 2.0e9
    bytes_per_s: float = 1.0e9
    tick_overhead_s: float = 2.0e-4
    source: str = "default"  # "default" or "fitted"


@dataclasses.dataclass(frozen=True)
class PipelineEstimate:
    """Model-priced execution of one pipelined group: T ticks of the
    GPipe scan at ``t_tick_s`` each (compute and comm overlap only under
    the overlapped schedule), fill/drain diluting throughput by
    ``bubble_fraction``, the slowest stage setting the pace
    (``imbalance`` = max stage FLOPs / mean)."""

    n_ticks: int
    t_compute_s: float  # slowest stage body, one tick
    t_comm_s: float  # interior-edge traffic, one tick
    t_tick_s: float
    total_s: float
    frames_per_s: float
    bubble_fraction: float
    imbalance: float

    def summary(self) -> str:
        return (
            f"{self.n_ticks} ticks x {self.t_tick_s * 1e6:.0f}us "
            f"(compute {self.t_compute_s * 1e6:.0f}us, comm "
            f"{self.t_comm_s * 1e6:.0f}us) -> "
            f"{self.frames_per_s:.0f} frames/s, bubble "
            f"{self.bubble_fraction:.2f}, imbalance {self.imbalance:.2f}"
        )


def pipeline_workload(plan) -> tuple:
    """(per-stage FLOPs per frame, per-interior-edge bytes per frame) of a
    compiled plan — the actor payloads the mapper balanced stages with,
    and the exact edge shapes the executor streams between slots."""
    from repro_torch.core.dhm.pipeline import plan_edges

    stage_flops = tuple(float(st.cost_flops) for st in plan.stages)
    ep = plan_edges([st.io for st in plan.stages])
    edge_bytes = tuple(
        4.0 * _prod(shape) for shape in ep.edge_shapes
    )
    return stage_flops, edge_bytes


def _prod(shape) -> float:
    n = 1.0
    for d in shape:
        n *= d
    return n


def estimate_pipeline(
    plan,
    *,
    n_microbatches: int,
    microbatch: int,
    data: int = 1,
    overlap: bool = False,
    edge_mode: str = "auto",
    constants: Optional[PipelineCostConstants] = None,
) -> PipelineEstimate:
    """Price one pipeline configuration for a compiled plan.

    Per tick every stage fires once on ``microbatch / data`` frames; the
    slowest stage body sets the compute time, the interior edges (grouped
    into shape classes per ``edge_mode`` — boxed classes pay for their
    padding) set the comm time. The serial schedule pays
    ``t_compute + t_comm`` per tick over ``M + (S-1)`` ticks; the
    overlapped schedule pays ``max(t_compute, t_comm)`` over
    ``M + 2(S-1)`` ticks (edges handed off beside the next body — latency traded for
    concurrency, see ``pipeline.py``).
    """
    from repro_torch.core.dhm.pipeline import plan_edges

    c = constants or PipelineCostConstants()
    S = plan.n_stages
    M = int(n_microbatches)
    if microbatch % data:
        raise ValueError(
            f"batch grain {microbatch} not divisible by data split {data}"
        )
    mb_local = microbatch // data
    stage_flops, _ = pipeline_workload(plan)
    f_max = max(stage_flops)
    ep = plan_edges([st.io for st in plan.stages], mode=edge_mode)
    # Boxed classes ship the class buffer for every edge in the class —
    # padding included — which is exactly what the executor sends.
    class_bytes = ep.class_bytes(4)
    sent_bytes = sum(class_bytes[ep.edge_class[e]] for e in range(ep.n_edges))
    t_compute = f_max * mb_local / c.flops_per_s
    t_comm = sent_bytes * mb_local / c.bytes_per_s
    delay = (2 if overlap else 1) * (S - 1)
    n_ticks = M + delay
    body = max(t_compute, t_comm) if overlap else t_compute + t_comm
    t_tick = c.tick_overhead_s + body
    total = n_ticks * t_tick
    mean_flops = sum(stage_flops) / len(stage_flops)
    return PipelineEstimate(
        n_ticks=n_ticks,
        t_compute_s=t_compute,
        t_comm_s=t_comm,
        t_tick_s=t_tick,
        total_s=total,
        frames_per_s=M * microbatch / total,
        bubble_fraction=delay / n_ticks,
        imbalance=f_max / mean_flops if mean_flops else 1.0,
    )


# ---------------------------------------------------------------------------
# Fitting the constants from measured sweeps.


def sweep_sample(
    plan,
    *,
    n_microbatches: int,
    microbatch: int,
    data: int,
    frames_per_s: float,
    overlap: bool = False,
    edge_mode: str = "auto",
) -> dict:
    """One measured sweep point in the form :func:`fit_constants` solves
    on: the per-run totals of the three cost features (FLOPs on the
    critical stage, edge bytes shipped, tick count) plus the measured
    wall time."""
    from repro_torch.core.dhm.pipeline import plan_edges

    S = plan.n_stages
    M = int(n_microbatches)
    mb_local = microbatch // data
    stage_flops, _ = pipeline_workload(plan)
    ep = plan_edges([st.io for st in plan.stages], mode=edge_mode)
    class_bytes = ep.class_bytes(4)
    sent = sum(class_bytes[ep.edge_class[e]] for e in range(ep.n_edges))
    n_ticks = M + (2 if overlap else 1) * (S - 1)
    return {
        "flops": n_ticks * max(stage_flops) * mb_local,
        "bytes": n_ticks * sent * mb_local,
        "ticks": float(n_ticks),
        "total_s": M * microbatch / frames_per_s,
        "overlap": bool(overlap),
    }


def fit_constants(samples: Sequence[dict]) -> PipelineCostConstants:
    """Least-squares fit of the three machine constants from measured
    serial-schedule sweep points (overlapped samples are excluded: their
    tick body is a max(), not a sum, so they are nonlinear in the
    constants). Falls back to defaults when the system is degenerate or
    the fit goes nonpositive (a sweep too small/collinear to trust)."""
    import numpy as np

    serial = [s for s in samples if not s.get("overlap")]
    if len(serial) < 3:
        return PipelineCostConstants()
    A = np.array(
        [[s["flops"], s["bytes"], s["ticks"]] for s in serial], dtype=float
    )
    b = np.array([s["total_s"] for s in serial], dtype=float)
    try:
        coef, _, rank, _ = np.linalg.lstsq(A, b, rcond=None)
    except np.linalg.LinAlgError:
        return PipelineCostConstants()
    if rank < 3 or np.any(coef <= 0):
        return PipelineCostConstants()
    inv_flops, inv_bytes, overhead = coef
    return PipelineCostConstants(
        flops_per_s=1.0 / inv_flops,
        bytes_per_s=1.0 / inv_bytes,
        tick_overhead_s=float(overhead),
        source="fitted",
    )


def load_sweep_measurements(
    history_path, topology: str, label: str = "fp32"
) -> list:
    """The ``path: pipeline_sweep`` rows recorded for one
    (topology, precision) across every run in ``BENCH_history.jsonl`` —
    the measured crossover sweep the autotuner trusts over its own model.
    Returns the raw row dicts (n_microbatches/microbatch/data/overlap/
    edge_mode/frames_per_s); missing file -> empty list."""
    path = pathlib.Path(history_path)
    if not path.exists():
        return []
    out = []
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        for row in rec.get("rows", ()):
            if (
                row.get("path") == "pipeline_sweep"
                and row.get("topology") == topology
                and row.get("label") == label
            ):
                out.append(row)
    return out


# ---------------------------------------------------------------------------
# The autotuner.


@dataclasses.dataclass(frozen=True)
class PipelineTuning:
    """The configuration the autotuner picked for (plan, device count):
    ``source`` records whether it came off a measured sweep point
    ("measured" — preferred whenever measurements exist) or the fitted
    cost model ("model"); ``estimate`` carries the model's pricing of the
    choice either way."""

    n_stages: int
    n_microbatches: int
    microbatch: int
    data: int
    overlap: bool
    edge_mode: str
    source: str
    frames_per_s: float  # measured (source="measured") or model estimate
    estimate: Optional[PipelineEstimate] = None

    def summary(self) -> str:
        return (
            f"S={self.n_stages} M={self.n_microbatches} "
            f"mb={self.microbatch} data={self.data} "
            f"overlap={self.overlap} edges={self.edge_mode} "
            f"[{self.source}] ~{self.frames_per_s:.0f} frames/s"
        )


def candidate_grid(
    plan,
    n_devices: int,
    *,
    microbatches: Sequence[int] = (1, 2, 4, 8),
    grains: Sequence[int] = (8, 16, 32),
    overlaps: Sequence[bool] = (False, True),
    edge_mode: str = "auto",
) -> list:
    """All (M, grain, data split, overlap) candidates that fit the mesh:
    the data split is whatever the stage axis leaves over, and the batch
    grain must divide across it."""
    S = plan.n_stages
    data = max(1, n_devices // S)
    out = []
    for mb in grains:
        if mb % data:
            continue
        for M in microbatches:
            for ov in overlaps:
                out.append(
                    {
                        "n_microbatches": int(M),
                        "microbatch": int(mb),
                        "data": int(data),
                        "overlap": bool(ov),
                        "edge_mode": edge_mode,
                    }
                )
    return out


def autotune_pipeline(
    plan,
    n_devices: int,
    *,
    measurements: Sequence[dict] = (),
    constants: Optional[PipelineCostConstants] = None,
    microbatches: Sequence[int] = (1, 2, 4, 8),
    grains: Sequence[int] = (8, 16, 32),
    overlaps: Sequence[bool] = (False, True),
    edge_mode: str = "auto",
) -> PipelineTuning:
    """Pick (n_microbatches, batch grain, data split, overlap) for a plan
    on an ``n_devices`` mesh.

    Measured sweep points (``measurements`` — e.g. from
    :func:`load_sweep_measurements`) outrank the model: when any
    measurement fits the mesh, the tuner returns the fastest *measured*
    configuration, so its choice is by construction within 0% of the best
    measured sweep point. Only with no usable measurements does it fall
    back to pricing the candidate grid with :func:`estimate_pipeline`
    under ``constants`` (fit them from the sweep via
    :func:`fit_constants` when you have one).
    """
    S = plan.n_stages
    data = max(1, n_devices // S)
    if constants is None:
        samples = [
            sweep_sample(
                plan,
                n_microbatches=m["n_microbatches"],
                microbatch=m["microbatch"],
                data=m["data"],
                frames_per_s=m["frames_per_s"],
                overlap=m.get("overlap", False),
                edge_mode=m.get("edge_mode", "auto"),
            )
            for m in measurements
            if m.get("n_stages", S) == S
        ]
        constants = fit_constants(samples)

    usable = [
        m
        for m in measurements
        if m.get("n_stages", S) == S
        and m.get("data", data) == data
        and m.get("frames_per_s", 0) > 0
    ]
    if usable:
        best = max(usable, key=lambda m: m["frames_per_s"])
        est = estimate_pipeline(
            plan,
            n_microbatches=best["n_microbatches"],
            microbatch=best["microbatch"],
            data=best["data"],
            overlap=best.get("overlap", False),
            edge_mode=best.get("edge_mode", "auto"),
            constants=constants,
        )
        return PipelineTuning(
            n_stages=S,
            n_microbatches=int(best["n_microbatches"]),
            microbatch=int(best["microbatch"]),
            data=int(best["data"]),
            overlap=bool(best.get("overlap", False)),
            edge_mode=str(best.get("edge_mode", "auto")),
            source="measured",
            frames_per_s=float(best["frames_per_s"]),
            estimate=est,
        )

    cands = candidate_grid(
        plan,
        n_devices,
        microbatches=microbatches,
        grains=grains,
        overlaps=overlaps,
        edge_mode=edge_mode,
    )
    if not cands:
        raise ValueError(
            f"no pipeline candidate fits {n_devices} devices for "
            f"{S} stages (grains {tuple(grains)})"
        )
    best_c, best_est = None, None
    for cand in cands:
        est = estimate_pipeline(plan, constants=constants, **cand)
        if best_est is None or est.frames_per_s > best_est.frames_per_s:
            best_c, best_est = cand, est
    return PipelineTuning(
        n_stages=S,
        n_microbatches=best_c["n_microbatches"],
        microbatch=best_c["microbatch"],
        data=best_c["data"],
        overlap=best_c["overlap"],
        edge_mode=best_c["edge_mode"],
        source="model",
        frames_per_s=best_est.frames_per_s,
        estimate=best_est,
    )
