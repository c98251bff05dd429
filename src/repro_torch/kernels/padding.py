"""Shared padding/rounding helpers for the kernel wrappers.

Zero padding is exact for every kernel here: zero input rows/channels
contribute zero partial sums.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def round_up(x: int, mult: int) -> int:
    """Smallest multiple of ``mult`` >= x."""
    return -(-x // mult) * mult


def pad_axis_to(x: torch.Tensor, axis: int, target: int) -> torch.Tensor:
    """Zero-pad ``axis`` up to ``target`` elements (no-op if already there)."""
    pad = target - x.shape[axis]
    if pad <= 0:
        return x
    axis = axis % x.ndim
    # F.pad lists (low, high) pairs from the LAST dim backwards.
    widths = [0, 0] * (x.ndim - axis)
    widths[-1] = pad
    return F.pad(x, widths)


def pad_axis_to_multiple(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    """Zero-pad ``axis`` up to the next multiple of ``mult``."""
    return pad_axis_to(x, axis, round_up(x.shape[axis], mult))
