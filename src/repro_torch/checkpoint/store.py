"""Checkpoint store.

The reference's format and contract, so that a checkpoint written by one
package loads in the other:

- **Atomic commits**: state is written to ``step_N.tmp/`` then renamed;
  a crash mid-write never corrupts the latest checkpoint. The rename is
  the commit point.
- **Step-indexed retention**: the ``keep`` newest checkpoints are kept.
- **Layout**: one ``leaf_NNNNN.npy`` per leaf, in JAX's flatten order
  (``repro_torch.tree_util``: sorted dict keys, lists and NamedTuple
  fields in order, ``None`` holds no leaf), and ``meta.json`` with the
  leaf count and the structure as JAX renders it. Shapes are validated on
  load.

Async: ``save`` copies the state to the host (a synchronizing copy off
the card), then writes the files on a worker thread, overlapping the next
step; ``wait()`` joins the outstanding write.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree_util import tree_flatten, tree_map

_LEAF_FILE = "leaf_{:05d}.npy"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree: Any) -> None:
    """Write a pytree to ``path`` (directory), atomically."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    leaves, treedef = tree_flatten(tree)
    meta = {"n_leaves": len(leaves), "treedef": str(treedef)}
    for i, leaf in enumerate(leaves):
        np.save(os.path.join(tmp, _LEAF_FILE.format(i)), _to_numpy(leaf))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)  # commit point


def load_pytree(path: str, like: Any) -> Any:
    """Load into the structure of ``like`` (shapes validated). A leaf whose
    ``like`` is a tensor comes back as a tensor on that tensor's device;
    any other leaf as a numpy array."""
    leaves_like, treedef = tree_flatten(like)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta["n_leaves"] != len(leaves_like):
        raise ValueError(
            f"checkpoint has {meta['n_leaves']} leaves, expected "
            f"{len(leaves_like)}"
        )
    out = []
    for i, ref in enumerate(leaves_like):
        arr = np.load(os.path.join(path, _LEAF_FILE.format(i)))
        ref_shape = tuple(getattr(ref, "shape", ()))
        if tuple(arr.shape) != ref_shape:
            raise ValueError(
                f"leaf {i}: checkpoint shape {arr.shape} != expected "
                f"{ref_shape}"
            )
        out.append(torch.from_numpy(arr).to(ref.device) if isinstance(ref, torch.Tensor) else arr)
    return treedef.unflatten(out)


class CheckpointManager:
    """Step-indexed checkpoint directory with retention + async writes."""

    STEP_RE = re.compile(r"^step_(\d+)$")

    def __init__(self, directory: str, *, keep: int = 3, async_write: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_write = async_write
        self._pending: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def _step_path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def all_steps(self) -> list:
        steps = []
        for name in os.listdir(self.directory):
            m = self.STEP_RE.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> None:
        """Snapshot to host, then write (on a worker thread if async)."""
        host_state = tree_map(_to_numpy, state)

        def _write():
            save_pytree(self._step_path(step), host_state)
            self._gc()

        self.wait()
        if self.async_write:
            self._pending = threading.Thread(target=_write, daemon=True)
            self._pending.start()
        else:
            _write()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def restore(self, like: Any, step: Optional[int] = None) -> tuple:
        """Returns (state, step). Raises FileNotFoundError if none exist."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return load_pytree(self._step_path(step), like), step

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self._step_path(s), ignore_errors=True)
