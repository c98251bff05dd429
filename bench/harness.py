"""The harness: finds a cell's pieces by name and turns a loop's outcome
into the result line.

Everything a cell needs is found from ``BENCHMARK.json`` by name:

- its configuration: the ``file`` of the ``configs`` entry it names;
- its traffic mix: ``bench/traffic/<traffic>.json``, whose ``kind`` names
  the loop ``bench/loops/<kind>.py``;
- its limits: ``bench/limits/<cell>.json``;
- each per-layer metric: ``bench/metrics/<metric>.py``, whose
  ``read(readings)`` returns a number, or None when it finds nothing to
  read (the metric is then left out of the line).

A cell reports the end-to-end metrics whose ``workloads`` list it (or that
have no list) and, in a traced run (whose window is at most
``TRACE_SECONDS`` long), the per-layer metrics whose
``workloads`` list it (or, without a list, that move an end-to-end metric
it reports). A new cell, mix or metric is a new file and a new entry.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

import torch

from bench.cell import Cell
from bench.correct import checks, load_limits

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
# A traced run's window: long enough for thousands of requests or hundreds
# of steps, short enough that the profiler's record is read in seconds.
TRACE_SECONDS = 3.0


def load_spec(path: Path = ROOT / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            with open(ROOT / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def mix(name: str) -> dict:
    with open(BENCH / "traffic" / f"{name}.json") as f:
        return json.load(f)


def loop(kind: str):
    return importlib.import_module(f"bench.loops.{kind}")


def metric_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _lists(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def end_to_end(spec: dict, cell: str) -> list:
    return [m for m in spec["end_to_end"] if _lists(m, cell)]


def per_layer(spec: dict, cell: str) -> list:
    e2e = {m["name"] for m in end_to_end(spec, cell)}

    def reported(m: dict) -> bool:
        return cell in m["workloads"] if "workloads" in m else m["moves"] in e2e

    return [m for m in spec["per_layer"] if reported(m)]


def peaks(kind: str) -> dict:
    with open(BENCH / "peaks.json") as f:
        table = json.load(f)
    for key, value in table.items():
        if key != "about" and key in kind:
            return value
    raise KeyError(f"no peaks for {kind!r} in bench/peaks.json")


def make_cell(spec: dict, name: str, *, seed: int, seconds: float, trace: bool, device,
              t_start: float, sizes=None) -> Cell:
    w = workload(spec, name)
    if trace:
        seconds = min(seconds, TRACE_SECONDS)
    return Cell(name=name, config=config(spec, w["config"]), mix=mix(w["traffic"]), seed=seed,
                seconds=seconds, trace=trace, device=torch.device(device), t_start=t_start,
                sizes=dict(sizes or {}))


def run(spec: dict, cell: Cell) -> tuple:
    """Run ``cell``; returns (the result line as a dict, the checks)."""
    outcome = loop(cell.mix["kind"]).run(cell)
    found = checks(outcome.values, load_limits(cell.name))
    metrics = {}
    if cell.trace:
        outcome.readings.peaks = peaks(_device_kind(cell))
        for m in per_layer(spec, cell.name):
            value = metric_reader(m["name"]).read(outcome.readings)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in end_to_end(spec, cell.name):
            metrics[m["name"]] = {"value": float(outcome.e2e[m["name"]]), "unit": m["unit"]}
    device = {"platform": "gpu" if cell.on_card else "cpu", "kind": _device_kind(cell),
              "count": 1, "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    line = {"correct": all(c.ok for c in found), "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": device}
    tr = outcome.readings.trace
    if tr is not None:
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        line["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in found}
    return line, found


def _device_kind(cell: Cell) -> str:
    if cell.on_card:
        return torch.cuda.get_device_name(cell.device)
    return "cpu"
