"""Host -> device loader with background prefetch.

The counterpart of ``repro.data.loader``. The reference puts each host
batch with ``jax.device_put`` (or assembles a global array from a
``NamedSharding``) and keeps a few puts in flight. The port copies each
array to the loader's device, asynchronously from pinned host memory on
the card, and keeps ``prefetch`` batches in flight the same way. An array
given a mesh in ``shardings`` is split along its leading (batch) axis over
the mesh's data axes (``launch.mesh.data_axes``) and each shard is put on
every slot of its data coordinate, on that slot's stream: the array comes
back as the list of per-slot tensors, in ``mesh.slots`` order. Work on a
slot's stream sees its shard; work on another stream waits on that
stream first.
"""
from __future__ import annotations

import collections
import math
from typing import Iterator, Mapping

import numpy as np
import torch

from repro_torch import cuda_graphs
from repro_torch.kernels.backends import resolve_device
from repro_torch.launch.mesh import Mesh, data_axes


def _put(array, device: torch.device, stream=None) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(array))
    if device.type != "cuda":
        return t.to(device, copy=True)
    if stream is None:
        return t.pin_memory().to(device, non_blocking=True)
    # A slot's stream may be under capture on another thread: hold the lock.
    with cuda_graphs.CAPTURE_LOCK, torch.cuda.stream(stream):
        return t.pin_memory().to(device, non_blocking=True)


def _shard(array, mesh: Mesh) -> list:
    """The array split over the mesh's data axes, one tensor per slot."""
    axes = data_axes(mesh)
    n = math.prod(mesh.shape[a] for a in axes)
    arr = np.asarray(array)
    if arr.shape[0] % n:
        raise ValueError(f"leading dim {arr.shape[0]} does not split over {n} data slots of {mesh}")
    pieces = np.split(arr, n)
    idx = [mesh.axis_names.index(a) for a in axes]
    out = []
    for slot in mesh.slots:
        k = 0
        for i in idx:  # row-major position over the data axes
            k = k * mesh.shape[mesh.axis_names[i]] + slot.coords[i]
        out.append(_put(pieces[k], slot.device, slot.stream))
    return out


class ShardedLoader:
    """Iterate ``host_iter``'s numpy batches as tensors on ``device`` (the
    card unless ``device="cpu"``), ``prefetch`` batches ahead; a key of
    ``shardings`` maps to a mesh its array is split over."""

    def __init__(
        self,
        host_iter: Iterator[Mapping[str, np.ndarray]],
        shardings: Mapping[str, Mesh] | None = None,
        *,
        prefetch: int = 2,
        device=None,
    ) -> None:
        self._host_iter = host_iter
        self._shardings = shardings or {}
        self._device = resolve_device(device)
        self._prefetch = max(1, prefetch)
        self._queue: collections.deque = collections.deque()

    def _put(self, batch: Mapping[str, np.ndarray]) -> dict:
        out = {}
        for k, v in batch.items():
            mesh = self._shardings.get(k)
            out[k] = _put(v, self._device) if mesh is None else _shard(v, mesh)
        return out

    def __iter__(self):
        return self

    def __next__(self):
        while len(self._queue) < self._prefetch:
            try:
                self._queue.append(self._put(next(self._host_iter)))
            except StopIteration:
                break
        if not self._queue:
            raise StopIteration
        return self._queue.popleft()
