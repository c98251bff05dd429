"""Carry parameters across from the reference package.

The reference builds its params with ``jax.random`` (``init_cnn``); the
port's generator draws other numbers from the same seed. To run both
packages on the same weights, take the reference's tree to numpy
(``jax.device_get(init_cnn(...))``) and hand it to
:func:`params_from_numpy`. Layouts stay the reference's — HWIO conv
kernels, ``(in, out)`` FC weights — so nothing is transposed.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.backends import resolve_device


def params_from_numpy(tree: dict, device=None) -> dict:
    """``{"conv": [{"w", "b"}...], "fc": [{"w", "b"}...]}`` of numpy arrays
    (or anything ``np.asarray`` takes) -> the same tree of float32
    tensors on ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    return {
        group: [
            {
                name: torch.from_numpy(
                    np.array(a, dtype=np.float32, copy=True)
                ).to(dev)
                for name, a in layer.items()
            }
            for layer in layers
        ]
        for group, layers in tree.items()
    }
