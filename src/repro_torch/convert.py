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


def _leaf_to_torch(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (``jax.device_get`` hands back
        # ml_dtypes arrays, which torch.from_numpy refuses): move the bits.
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def lm_params_from_numpy(tree, device=None):
    """The reference's LM parameter tree (nested dicts and lists of numpy
    arrays, with ``None`` for an absent stack part, as
    ``jax.device_get(init_params(...))`` gives it) -> the same tree of
    tensors on ``device`` (the card unless ``device="cpu"``). Each leaf
    keeps its dtype and its bits: bf16 weights stay bf16 beside the f32
    ``a_log`` and ``d_skip``."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        if node is None:
            return None
        return _leaf_to_torch(node, dev)

    return walk(tree)
