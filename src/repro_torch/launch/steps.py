"""Train and serve steps — the counterpart of ``repro.launch.steps``:
train_step (loss + grad + clip + AdamW, with µbatch gradient
accumulation) and serve steps (prefill / single-token decode).

The reference jits each step with explicit in/out shardings and donates
the parameters and optimizer state. The port runs one card: the train
and prefill steps are eager functions of tensor trees (the updated trees
are new tensors, as ``adamw_update`` returns them). The train step has a
jitted form, :func:`jit_train_step` (a ``cuda_graphs.JittedTrainStep``:
one CUDA graph per (batch, trees), the parameters and optimizer state
donated), and so has the decode step, :func:`jit_decode_step` (one CUDA
graph per (batch, cache) with the cache donated). The layouts are still
computed by ``launch/sharding.py``.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import torch

from repro_torch import cuda_graphs
from repro_torch.cuda_graphs import JittedTrainStep
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.kernels import probe
from repro_torch.models.transformer import _decode_into
from repro_torch.models.transformer import decode_step as model_decode_step
from repro_torch.models.transformer import prefill as model_prefill
from repro_torch.models.transformer import train_loss
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, clip_by_global_norm
from repro_torch.tree_util import tree_flatten, tree_leaves, tree_map

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
    """The jitted train step and the optimizer state's shapes
    (``adamw_init`` over the meta parameter tree ``params_sds``, as
    ``specs.params_shapes`` gives it): the counterpart of the reference's
    ``jax.jit`` of :func:`make_train_step` with ``donate_argnums=(0, 1)``.
    The step is a ``cuda_graphs.JittedTrainStep`` of ``make_train_step``'s step
    (which ignores the step count), donating the params and optimizer
    state; its ``eager`` is that step itself, what the dry run traces.
    ``batch_sds`` is the reference's argument (its shardings): the step is
    keyed on the batch it is called with."""
    eager = make_train_step(cfg, mesh, microbatches=microbatches, **kw)

    def step(params, opt_state, batch, _step):
        return eager(params, opt_state, batch)

    return (JittedTrainStep(step, donate=True, eager=eager),
            adamw_init(params_sds, AdamWConfig()))


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


@dataclasses.dataclass
class _DecodeGraph:
    """One key of a :class:`JittedDecode`: its static token, index and
    cache (the tree and its leaves), the storage of the parameters it was
    last run with and, on the card, the graph, its static logits, the
    launches one replay makes ((name, shared-memory bytes) each) and the
    event after the last call's output copies."""

    token: torch.Tensor
    index: torch.Tensor
    cache: object
    leaves: list
    params: tuple = ()
    graph: Optional[object] = None  # torch.cuda.CUDAGraph
    logits: Optional[torch.Tensor] = None
    launches: tuple = ()
    done: Optional[object] = None  # torch.cuda.Event


def _storage(params) -> tuple:
    """Every ``params`` leaf's storage (data pointer, shape, stride, dtype):
    what a captured graph reads its weights from."""
    return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                 for t in tree_leaves(params))


class JittedDecode:
    """``step(params, cache, token, index) -> (logits, cache)``, the decode
    step as one captured executable per (batch, cache): the counterpart of
    ``jax.jit(make_decode_step(cfg), donate_argnums=(1,))``
    (:func:`jit_decode_step`).

    The key is the token's shape and dtype and the cache tree's structure,
    shapes and dtypes. A key keeps the storage of the ``params`` leaves it
    was captured on (data pointer, shape, stride, dtype): weights at new
    addresses drop that key's graph and capture it anew on the same static
    buffers, so a graph never reads stale weights and a server that swaps
    weights keeps one graph per key.

    On the card, the first call of a key copies the cache into static
    buffers of its own, fills a static token and index, and runs the step
    that writes into its cache (``transformer._decode_into``) once
    eagerly on a side stream, which is that call's result; then it
    captures the same step on the same buffers
    (``repro_torch/cuda_graphs.py``). Every later call copies the token in,
    fills the index (a host int by a device-side ``fill_``, a tensor by a
    device copy: the position is never read on the host), replays the
    graph and returns a clone of the static logits. The kernels run in the
    same order on the same shapes as the eager ``decode_step``, so the
    logits and the cache are its bit for bit. A capture that fails raises:
    nothing falls back to the eager step. A replay runs no wrapper, so the
    launches the capture logged (the ``ssm_scan`` of every Mamba layer)
    are counted again at each replay (``kernels/probe.py``).

    The cache is donated, as the reference's ``dryrun.py`` donates it:
    every call returns the key's static cache tree, valid until the next
    call. A caller that hands that tree back gets a replay with no copy of
    the cache. Any other cache is copied into the static one and left as
    it was; a caller that keeps a cache across calls clones it, or runs
    the eager ``decode_step``.

    On the CPU, each call is the eager step on the same static buffers
    (same surface; ``_cache_size()`` counts the keys run). The step
    records no autograd graph.

    The static buffers are shared: ``lock`` (reentrant) is held around
    staging, the step and the output copies.
    """

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.lock = threading.RLock()
        self._graphs: dict = {}  # key -> _DecodeGraph
        self._stream = None  # the side stream of warm-ups and captures

    def _cache_size(self) -> int:
        """The keys captured (on the CPU: run) so far."""
        return len(self._graphs)

    def clear(self) -> None:
        """Drop every graph and its static buffers."""
        with self.lock:
            self._graphs.clear()

    def __call__(self, params, cache, token, index):
        token = torch.as_tensor(token)
        with self.lock, torch.inference_mode(False), torch.no_grad():
            leaves, treedef = tree_flatten(cache)
            key = (tuple(token.shape), token.dtype, treedef,
                   tuple((tuple(t.shape), t.dtype) for t in leaves))
            dev = leaves[0].device
            on_card = dev.type == "cuda"
            entry = self._graphs.get(key)
            fresh = entry is None
            if fresh:
                static = tree_map(torch.empty_like, cache)
                entry = _DecodeGraph(
                    token=torch.empty(token.shape, dtype=token.dtype, device=dev),
                    index=torch.zeros((), dtype=torch.long, device=dev),
                    cache=static, leaves=tree_leaves(static))
            storage = _storage(params)
            if storage != entry.params:
                # New weights: the old graph (and its pool) goes, the key recaptures.
                entry.params, entry.graph, entry.logits, entry.launches = storage, None, None, ()
            stream = torch.cuda.current_stream(dev) if on_card else None
            if entry.done is not None:
                stream.wait_event(entry.done)
            entry.token.copy_(token)
            if isinstance(index, torch.Tensor):
                entry.index.copy_(index.reshape(()))
            else:
                entry.index.fill_(int(index))
            if not all(a is b for a, b in zip(leaves, entry.leaves)):
                for dst, src in zip(entry.leaves, leaves):
                    dst.copy_(src)

            def step():
                return _decode_into(params, self.cfg, entry.token, entry.cache, entry.index)[0]

            if not on_card:
                logits = step()
            elif entry.graph is None:
                if self._stream is None:
                    self._stream = torch.cuda.Stream(dev)
                cap = cuda_graphs.capture(step, dev, self._stream)
                entry.graph, entry.logits, entry.launches = cap.graph, cap.out, cap.launches
                logits = cap.warm
                logits.record_stream(stream)
            else:
                entry.graph.replay()
                probe.replayed(entry.launches)
                logits = entry.logits.clone()
            if fresh:
                self._graphs[key] = entry
            if on_card:
                if entry.done is None:
                    entry.done = torch.cuda.Event()
                entry.done.record(stream)
            return logits, entry.cache


def jit_decode_step(cfg: ArchConfig) -> JittedDecode:
    """The jitted decode step of ``cfg``: the counterpart of
    ``jax.jit(make_decode_step(cfg), donate_argnums=(1,))``. A new object,
    which keeps one CUDA graph per (token shape, cache shapes) it is called
    with, as a fresh ``make_decode_step`` closure under ``jax.jit`` keeps
    its executables; new weights recapture a key's graph in place."""
    return JittedDecode(cfg)
