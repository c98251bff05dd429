"""Train and serve steps — the counterpart of ``repro.launch.steps``:
train_step (loss + grad + clip + AdamW, with µbatch gradient
accumulation) and serve steps (prefill / single-token decode).

The reference jits each step with explicit in/out shardings and donates
the parameters and optimizer state. The port runs one card: a step is an
eager function of tensor trees, nothing is compiled and nothing donated
(the updated trees are new tensors, as ``adamw_update`` returns them).
The layouts are still computed by ``launch/sharding.py``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.transformer import decode_step as model_decode_step
from repro_torch.models.transformer import prefill as model_prefill
from repro_torch.models.transformer import train_loss
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, clip_by_global_norm
from repro_torch.tree_util import tree_flatten, tree_map

VOCAB_CHUNK = 8192


def opt_specs_like(param_spec_tree):
    """Optimizer-state specs: moments mirror the param layout."""
    return param_spec_tree


def _split(batch: dict, microbatches: int) -> list:
    """The batch's leading dim cut into ``microbatches`` consecutive µbatches
    (the reference's reshape to (µbatches, B / µbatches, ...))."""
    for x in batch.values():
        b = x.shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} not divisible by µbatches {microbatches}")
    return [{k: x.reshape((microbatches, x.shape[0] // microbatches) + tuple(x.shape[1:]))[i]
             for k, x in batch.items()} for i in range(microbatches)]


def make_train_step(cfg: ArchConfig, mesh=None, *, lr: float = 3e-4,
                    opt_cfg: Optional[AdamWConfig] = None, microbatches: int = 1):
    """The train step ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``. ``microbatches > 1`` enables gradient accumulation: the
    global batch is split along its leading dim and run µbatch by µbatch,
    the float32 gradients summed (each divided by the µbatch count),
    dividing the live activation set by the µbatch count; the optimizer
    update happens once. ``mesh`` is the reference's argument (one card:
    nothing is sharded)."""
    opt_cfg = opt_cfg or AdamWConfig()

    def loss_and_grads(params, batch):
        leaves, treedef = tree_flatten(params)
        leaves = [t.detach().requires_grad_() for t in leaves]
        loss, metrics = train_loss(treedef.unflatten(leaves), cfg, batch,
                                   vocab_chunk=VOCAB_CHUNK)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, treedef.unflatten(
            list(grads))

    def step(params, opt_state, batch):
        if microbatches == 1:
            loss, metrics, grads = loss_and_grads(params, batch)
        else:
            mbs = _split(batch, microbatches)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                             params)
            loss = torch.zeros((), dtype=torch.float32, device=mbs[0]["tokens"].device)
            aux = torch.zeros_like(loss)
            for mb in mbs:
                loss_i, metrics_i, g = loss_and_grads(params, mb)
                grads = tree_map(lambda a, b: a + b.float() / microbatches, grads, g)
                loss = loss + loss_i / microbatches
                aux = aux + metrics_i["aux"] / microbatches
            metrics = {"ce": loss, "aux": aux}
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        params, opt_state = adamw_update(grads, opt_state, params, opt_cfg, lr)
        return params, opt_state, dict(metrics, loss=loss, grad_norm=gnorm)

    return step


def jit_train_step(cfg: ArchConfig, mesh, params_sds, batch_sds, microbatches: int = 1, **kw):
    """The train step and the optimizer state's shapes (``adamw_init`` over
    the meta parameter tree ``params_sds``, as ``specs.params_shapes``
    gives it). The reference jits the step with shardings and donation;
    here the step runs eagerly (``batch_sds`` is the reference's argument:
    an eager step takes any batch of that layout)."""
    step = make_train_step(cfg, mesh, microbatches=microbatches, **kw)
    return step, adamw_init(params_sds, AdamWConfig())


def make_prefill_step(cfg: ArchConfig, shape: ShapeConfig):
    def step(params, batch):
        return model_prefill(params, cfg, batch["tokens"], max_len=shape.seq_len,
                             prefix_embeds=batch.get("prefix_embeds"),
                             encoder_frames=batch.get("encoder_frames"))

    return step


def make_decode_step(cfg: ArchConfig):
    def step(params, cache, token, index):
        return model_decode_step(params, cfg, token, cache, index)

    return step
