"""The traced window: the profiler's record of the device, and the
benchmark's own host spans.

``Tracer`` wraps a run's window in ``torch.profiler`` (CPU and CUDA
activities) when tracing is on, and is a no-op otherwise. The loop marks
what the host is doing with :meth:`Tracer.span` (``bench.*`` names). On
exit the trace is exported to a temporary file, read and deleted:

- ``device``: every kernel, copy and memset the card ran, as (name,
  start, end) in seconds;
- ``spans``: every ``bench.*`` host span, as (name, start, end).

The device's busy time is the union of those intervals, never their sum
(:func:`union`): overlapping kernels count once.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union(intervals) -> list:
    """The merged, sorted union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


@dataclasses.dataclass
class Trace:
    device: list  # (name, start_s, end_s)
    spans: list  # (name, start_s, end_s)

    @property
    def window(self) -> tuple:
        """From the first host span's start to the last span's or device
        operation's end."""
        start = min(s for _, s, _ in self.spans)
        end = max([e for _, _, e in self.spans] + [e for _, _, e in self.device])
        return start, end

    @property
    def window_s(self) -> float:
        s, e = self.window
        return e - s

    def busy(self) -> list:
        s0, e0 = self.window
        return union((max(s, s0), min(e, e0)) for _, s, e in self.device if e > s0 and s < e0)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def device_seconds(self, match) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(e - s for n, s, e in self.device if match(n))

    def top_ops(self, n: int = 10) -> list:
        """[name, seconds] of the device operations that took most time."""
        by: dict = {}
        for name, s, e in self.device:
            key = name.split("(")[0][:160]
            by[key] = by.get(key, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """[what the host was doing, seconds] of the device's idle time in
        the window, summed by the innermost host span that holds each
        gap's middle."""
        s0, e0 = self.window
        busy = self.busy()
        edges = [s0] + [x for iv in busy for x in iv] + [e0]
        by: dict = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            holding = [(e - s, name) for name, s, e in self.spans if s <= mid <= e]
            key = "host: " + (min(holding)[1] if holding else "outside any span")
            by[key] = by.get(key, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def read_chrome_trace(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    device, spans = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev["dur"]) * 1e-6
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat in DEVICE_CATS:
            device.append((name, s, e))
        elif cat == "user_annotation" and name.startswith("bench."):
            spans.append((name, s, e))
    return Trace(device=device, spans=spans)


class Tracer:
    """``with Tracer(on) as tr: ... with tr.span("bench.x"): ...``; after the
    block, ``tr.trace`` is the :class:`Trace` (None when off)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.trace = None
        self._prof = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def __enter__(self):
        if self.enabled:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if not self.enabled:
            return False
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            self.trace = read_chrome_trace(path)
        finally:
            os.unlink(path)
        self._prof = None
        return False
