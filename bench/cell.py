"""What a traffic loop is given and what it hands back.

A loop (``bench/loops/<kind>.py``, named by a traffic mix's ``kind``)
has one function, ``run(cell: Cell) -> Outcome``: set-up, the measured
window, then the check of its outputs against the reference. The harness
(``bench/harness.py``) turns the outcome into the result line.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from bench.trace import Trace


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float  # time.perf_counter() when the process started
    sizes: dict = dataclasses.field(default_factory=dict)  # tests' smaller sizes

    def size(self, key: str):
        """A size of the mix, unless a test gave a smaller one."""
        return self.sizes.get(key, self.mix[key])

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.device)

    def setup_s(self) -> float:
        return time.perf_counter() - self.t_start


@dataclasses.dataclass
class Readings:
    """What a per-layer metric reads (``bench/metrics/<name>.py``
    ``read(readings)``): the traced window, the benchmark's host spans by
    the host clock (name -> seconds of each), the work done in the traced
    window, and the card's peaks."""

    cell: Cell
    trace: Optional[Trace]
    host_s: dict
    work: dict
    peaks: dict


@dataclasses.dataclass
class Outcome:
    e2e: dict  # end-to-end metric -> value
    readings: Readings
    values: dict  # number compared -> value
    attempted: int
    failed: int
    memory_peak_bytes: int
