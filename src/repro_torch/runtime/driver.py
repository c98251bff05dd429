"""Fault-tolerant training runtime.

When the mean time between node failures drops below the job length, the
loop must be restart-safe by construction:

- **Checkpoint/restart**: the driver checkpoints every ``ckpt_every``
  steps (atomic commits, see ``repro_torch.checkpoint``). On a failure it
  restores the latest checkpoint and replays: batches come from
  ``batch_fn(step)``, so replayed batches are identical, and with
  deterministic kernels the replayed run repeats the clean one.
- **Straggler mitigation**: per-step wall times feed a robust
  (median/MAD) detector; stragglers are recorded and surfaced.
- **Elastic re-meshing**: on a permanent capacity change the mesh is
  rebuilt on the surviving devices (a ``launch.mesh.Mesh``: one slot per
  position, each with its device and, on CUDA, its own stream) and each
  tensor of the state is moved to its new slot's device.

Failures are injected deterministically in tests via ``FaultInjector``;
the driver itself only sees exceptions.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch.mesh import Mesh, Slot
from repro_torch.tree_util import tree_flatten


class NodeFailure(RuntimeError):
    """A (simulated or real) irrecoverable worker failure."""


@dataclasses.dataclass
class FaultInjector:
    """Deterministic failure schedule: raise NodeFailure at given steps."""

    fail_at_steps: tuple = ()
    fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise NodeFailure(f"injected failure at step {step}")


class StragglerMonitor:
    """Median/MAD step-time outlier detector."""

    def __init__(self, threshold: float = 3.0, window: int = 50):
        self.threshold = threshold
        self.window = window
        self.times: list = []
        self.flagged: list = []

    def record(self, step: int, seconds: float) -> bool:
        self.times.append(seconds)
        recent = self.times[-self.window:]
        if len(recent) < 5:
            return False
        med = float(np.median(recent))
        mad = float(np.median(np.abs(np.asarray(recent) - med))) + 1e-9
        is_straggler = seconds > med + self.threshold * 1.4826 * mad and (
            seconds > 1.5 * med
        )
        if is_straggler:
            self.flagged.append((step, seconds, med))
        return is_straggler


class ElasticMesh:
    """Rebuild the mesh on a surviving device set and move the state."""

    def __init__(self, axis_names=("data", "model")):
        self.axis_names = axis_names

    def best_shape(self, n_devices: int, *, model_parallel: int = 1) -> tuple:
        model = min(model_parallel, n_devices)
        while n_devices % model:
            model -= 1
        return (n_devices // model, model)

    def remesh(self, devices, *, model_parallel: int = 1) -> Mesh:
        """A mesh over the first ``data x model`` of ``devices`` (the
        survivors), one slot per device in row-major order."""
        devices = [torch.device(d) for d in devices]
        shape = self.best_shape(len(devices), model_parallel=model_parallel)
        coords = itertools.product(*(range(n) for n in shape))
        slots = [
            Slot(coords=c, device=d,
                 stream=torch.cuda.Stream(device=d) if d.type == "cuda" else None)
            for c, d in zip(coords, devices)
        ]
        return Mesh(self.axis_names, shape, slots)

    def reshard_state(self, state: Any, spec_tree, mesh: Mesh):
        """Move each tensor of ``state`` to the device of its slot in the
        new ``mesh``. ``spec_tree`` matches ``state`` leaf for leaf with the
        slot's coordinates (a tuple; None is the first slot); other leaves
        are returned as they are."""
        leaves, treedef = tree_flatten(state)
        specs = treedef.flatten_up_to(spec_tree)

        def move(leaf, spec):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            slot = mesh.slots[0] if spec is None else mesh.slot(*spec)
            return leaf.to(slot.device)

        return treedef.unflatten([move(leaf, s) for leaf, s in zip(leaves, specs)])


class ResilientTrainer:
    """Checkpoint/restart training loop.

    step_fn(state, batch, step) -> (state, metrics); batches come from
    batch_fn(step) so replay after restore is deterministic.
    """

    def __init__(
        self,
        step_fn: Callable,
        batch_fn: Callable,
        ckpt: CheckpointManager,
        *,
        ckpt_every: int = 50,
        max_restarts: int = 10,
        straggler: Optional[StragglerMonitor] = None,
        fault_injector: Optional[FaultInjector] = None,
        on_failure: Optional[Callable] = None,
    ):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.straggler = straggler or StragglerMonitor()
        self.fault_injector = fault_injector
        self.on_failure = on_failure
        self.restarts = 0
        self.history: list = []

    def run(self, state: Any, *, start_step: int = 0, num_steps: int) -> tuple:
        """Run to ``num_steps`` total steps, surviving failures.

        Returns (final_state, last_step_metrics). A failure before the
        first checkpoint restarts from ``start_step`` with the ``state``
        given here (the reference keeps the state the failed run had
        reached, so its cold restart replays on updated parameters).
        """
        initial = state
        step = start_step
        metrics = None
        # Resume from the newest checkpoint if one exists.
        latest = self.ckpt.latest_step()
        if latest is not None and latest > step:
            state, step = self.ckpt.restore(state)
            step += 1
        while step < num_steps:
            try:
                t0 = time.perf_counter()
                if self.fault_injector is not None:
                    self.fault_injector.check(step)
                batch = self.batch_fn(step)
                state, metrics = self.step_fn(state, batch, step)
                dt = time.perf_counter() - t0
                self.straggler.record(step, dt)
                self.history.append({"step": step, "seconds": dt})
                if (step + 1) % self.ckpt_every == 0 or step == num_steps - 1:
                    self.ckpt.save(step, state)
                step += 1
            except NodeFailure as e:
                self.restarts += 1
                if self.on_failure is not None:
                    self.on_failure(step, e)
                if self.restarts > self.max_restarts:
                    raise RuntimeError(
                        f"exceeded max_restarts={self.max_restarts}"
                    ) from e
                try:
                    state, restored = self.ckpt.restore(state)
                    step = restored + 1
                except FileNotFoundError:
                    state, step = initial, start_step  # no checkpoint yet: cold restart
        self.ckpt.wait()
        return state, metrics
