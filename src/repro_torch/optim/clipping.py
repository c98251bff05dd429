"""Global-norm gradient clipping."""
from __future__ import annotations

import torch

from repro_torch.tree_util import tree_leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(
        sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves)
    )


def clip_by_global_norm(grads, max_norm: float):
    """Returns (clipped_grads, pre_clip_norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm
