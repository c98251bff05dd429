"""Error-feedback int8 gradient compression for data-parallel all-reduce.

Quantize each gradient leaf per tensor to int8 codes with a float scale,
all-reduce the int8 payload (4x less traffic than fp32), and keep the
quantization error locally for the next step's gradient (error feedback
keeps the method convergent). These are pure functions: a training step
wires them around its all-reduce. The codes are the reference's, bit for
bit: the same float32 scale, division and round-half-to-even.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree_util import tree_flatten, tree_map


class ErrorFeedbackState(NamedTuple):
    residual: Any  # tree like grads, fp32


def ef_init(grads_shape_tree) -> ErrorFeedbackState:
    return ErrorFeedbackState(
        residual=tree_map(
            lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
            grads_shape_tree,
        )
    )


def compress_grads_int8(grads, ef: ErrorFeedbackState | None = None):
    """Quantize each leaf to (int8 codes, fp32 scale); fold in the EF
    residual. Returns (codes_tree, scales_tree, new_ef_state)."""

    def _leaf(g, r):
        g32 = g.to(torch.float32) + (r if r is not None else 0.0)
        scale = torch.max(torch.abs(g32)) / 127.0 + 1e-12
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        err = g32 - q.to(torch.float32) * scale
        return q, scale, err

    flat_g, treedef = tree_flatten(grads)
    flat_r = treedef.flatten_up_to(ef.residual) if ef is not None else [None] * len(flat_g)
    outs = [_leaf(g, r) for g, r in zip(flat_g, flat_r)]
    codes = treedef.unflatten([o[0] for o in outs])
    scales = treedef.unflatten([o[1] for o in outs])
    new_ef = ErrorFeedbackState(residual=treedef.unflatten([o[2] for o in outs]))
    return codes, scales, new_ef


def decompress_grads_int8(codes, scales):
    return tree_map(lambda q, s: q.to(torch.float32) * s, codes, scales)
