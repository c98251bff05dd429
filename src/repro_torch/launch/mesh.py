"""Mesh construction: a grid of slots over the card (or the CPU).

The counterpart of ``repro.launch.mesh``. The reference builds a
``jax.sharding.Mesh`` that one controller drives as an SPMD program. The
port's mesh is what one Python process drives instead: a grid of
**slots**, one per mesh position, each with a ``torch.device`` and, on
CUDA, its own ``torch.cuda.Stream``.

- On one card every slot sits on ``cuda:0``, so each slot is its own
  concurrent stream on that card.
- With more cards the slots go round-robin over ``cuda:0..n-1`` in the
  grid's row-major order.
- On the CPU (``device="cpu"``, what the tests use) every slot is
  ``cpu`` with no stream, and the work of the slots runs in order.

The default device is the card; without one ``make_mesh`` raises unless
the caller asks for the CPU (the policy of ``kernels/backends.py``).
No ``torch.distributed`` process group is involved: the reference is one
controller, and so is the port. ``make_production_mesh`` gives the
reference's production mesh shape and axes (16 x 16 per pod) as slots
over the cards there are; the LM's layouts over it come from
``launch/sharding.py``.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional

import torch

from repro_torch.kernels.backends import resolve_device


@dataclasses.dataclass(frozen=True)
class Slot:
    """One mesh position: its coordinates, its device and, on CUDA, the
    stream its work is enqueued on."""

    coords: tuple
    device: torch.device
    stream: Optional[object] = None  # torch.cuda.Stream on CUDA, None on the CPU


class Mesh:
    """A grid of :class:`Slot` over named axes.

    ``axis_names`` the axes in order, ``shape`` a dict from axis to size,
    ``size`` the number of slots; ``slot(**coords)`` (or ``slot(*coords)``)
    one slot, ``slots`` all of them in row-major order, ``devices`` their
    devices."""

    def __init__(self, axis_names, sizes, slots):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.size = math.prod(self.shape.values())
        self._grid = {s.coords: s for s in slots}
        if len(self._grid) != self.size:
            raise ValueError(f"a {sizes} mesh needs {self.size} slots, got {len(self._grid)}")

    @property
    def slots(self) -> tuple:
        return tuple(self._grid[c] for c in itertools.product(*(range(n) for n in self.shape.values())))

    @property
    def devices(self) -> tuple:
        return tuple(s.device for s in self.slots)

    def slot(self, *coords, **named) -> Slot:
        """The slot at ``coords`` (positional, in axis order) or at named
        coordinates; an axis left out is taken at 0."""
        if coords and named:
            raise ValueError("give the coordinates by position or by name, not both")
        if named:
            unknown = set(named) - set(self.axis_names)
            if unknown:
                raise ValueError(f"unknown mesh axes {sorted(unknown)}; have {self.axis_names}")
            coords = tuple(int(named.get(a, 0)) for a in self.axis_names)
        return self._grid[tuple(coords)]

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self.devices})
        return f"Mesh({self.shape}, devices={devs})"


def make_mesh(shape, axes, *, device=None) -> Mesh:
    """A mesh of ``shape`` over the axes ``axes``: on the card unless
    ``device="cpu"``. On CUDA each slot gets its own stream, and the slots
    go round-robin over the visible cards (every slot on ``cuda:0`` with
    one card); ``device="cuda:k"`` puts every slot on card k."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if len(set(axes)) != len(axes):
        raise ValueError(f"mesh axes must be distinct, got {axes}")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh sizes must be >= 1, got {shape}")
    dev = resolve_device(device)
    coords = list(itertools.product(*(range(n) for n in shape)))
    slots = []
    for i, c in enumerate(coords):
        if dev.type == "cuda":
            d = dev if dev.index is not None else torch.device("cuda", i % torch.cuda.device_count())
            slots.append(Slot(coords=c, device=d, stream=torch.cuda.Stream(device=d)))
        else:
            slots.append(Slot(coords=c, device=torch.device("cpu")))
    return Mesh(axes, shape, slots)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """16x16 = 256 slots per pod; multi-pod adds a leading 2-pod axis (the
    reference's 256 and 512 chips). On the card unless ``device="cpu"``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def data_axes(mesh) -> tuple:
    """Axes the global batch shards over."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def model_axes(mesh) -> tuple:
    return tuple(a for a in ("model",) if a in mesh.axis_names)
