"""AdamW, functional, generic over nested dicts and lists of tensors.

State layout mirrors the params tree (one m/v slot per leaf), kept in
float32 regardless of param dtype (mixed-precision training: bf16 params,
fp32 master copies live in the state when ``keep_master_copy``). The
update is the reference's formula, term for term: bias-corrected moments,
decoupled weight decay, every term in float32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.tree_util import tree_flatten, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    keep_master_copy: bool = False  # fp32 master params for bf16 training


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: Any  # first moment, fp32
    v: Any  # second moment, fp32
    master: Any  # fp32 master params or None


def adamw_init(params: Any, cfg: AdamWConfig) -> OptState:
    leaves = tree_flatten(params)[0]
    device = leaves[0].device if leaves else torch.device("cpu")

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    master = (
        tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)
        if cfg.keep_master_copy
        else None
    )
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=tree_map(zeros, params),
        v=tree_map(zeros, params),
        master=master,
    )


@torch.no_grad()
def adamw_update(grads: Any, state: OptState, params: Any, cfg: AdamWConfig, lr):
    """One AdamW step. Returns (new_params, new_state); nothing is updated
    in place. ``lr`` is a number or a 0-d tensor, used where it lives: a
    schedule's value on the card (``schedules.py``) keeps the step free of
    host reads, so a CUDA graph of it reads each step's rate."""
    step = state.step + 1
    t = step.to(torch.float32)
    # torch.full, not torch.tensor: the same ops on every device, meta
    # included (a dry run's op log is the card's).
    c1 = 1.0 - torch.pow(torch.full((), cfg.b1, dtype=torch.float32, device=t.device), t)
    c2 = 1.0 - torch.pow(torch.full((), cfg.b2, dtype=torch.float32, device=t.device), t)
    lr = torch.as_tensor(lr, dtype=torch.float32)

    source = state.master if cfg.keep_master_copy else params

    def _leaf(g, m, v, p):
        g32 = g.to(torch.float32)
        m_new = cfg.b1 * m + (1 - cfg.b1) * g32
        v_new = cfg.b2 * v + (1 - cfg.b2) * torch.square(g32)
        update = (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps)
        p32 = p.to(torch.float32)
        p_new = p32 - lr * (update + cfg.weight_decay * p32)
        return m_new, v_new, p_new

    flat_g, treedef = tree_flatten(grads)
    outs = [
        _leaf(*leaf)
        for leaf in zip(flat_g, treedef.flatten_up_to(state.m),
                        treedef.flatten_up_to(state.v), treedef.flatten_up_to(source))
    ]
    new_m = treedef.unflatten([o[0] for o in outs])
    new_v = treedef.unflatten([o[1] for o in outs])
    new_p32 = treedef.unflatten([o[2] for o in outs])
    new_params = tree_map(lambda p32, p: p32.to(p.dtype), new_p32, params)
    master = new_p32 if cfg.keep_master_copy else None
    return new_params, OptState(step=step, m=new_m, v=new_v, master=master)
