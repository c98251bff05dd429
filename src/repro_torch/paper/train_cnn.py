"""Training driver for the paper's CNN topologies.

Trains on the deterministic synthetic image task (``repro_torch.data``),
optionally with fixed-point quantization-aware fine-tuning (the paper's
footnote-2 retraining step). The forward is ``cnn_apply``: the compiled
DHM plan, whose conv groups run the stream-conv kernels on the card; the
gradient is autograd through them (``kernels/stream_conv/ops.py``). Loss,
optimizer, schedule and batch draw are the reference's
(``repro.paper.train_cnn``): from the same initial parameters and the
same dataset arrays both packages see the same batches. ``train_cnn``
runs its steps through :func:`jit_train_step`, the counterpart of the
reference's jitted ``step_fn``: on the card one CUDA graph of the whole
step per (topology, quant mode, batch shape). Artifacts are cached under
``$REPRO_RESULTS_DIR/cnn/`` (default ``results/cnn/``), in files of their
own (``<name>.torch.pkl``).
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import zlib
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import cuda_graphs
from repro_torch.core.dhm import QuantSpec, compile_dhm
from repro_torch.data import make_image_dataset
from repro_torch.kernels import probe
from repro_torch.kernels.backends import resolve_device
from repro_torch.models.cnn import CNNTopology, PAPER_TOPOLOGIES, cnn_apply, init_cnn
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    linear_warmup_cosine,
)
from repro_torch.tree_util import tree_flatten, tree_map

RESULTS_DIR = os.environ.get("REPRO_RESULTS_DIR", "results")


@dataclasses.dataclass
class TrainedCNN:
    topo: CNNTopology
    params: dict
    float_accuracy: float
    history: list


def _as_tensor(a, device, dtype=None) -> torch.Tensor:
    """A dataset array (a tensor, or a numpy array as the reference's
    arrays come across) on ``device``."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.array(a))
    return t.to(device=device, dtype=dtype)


def _loss_fn(params, topo, batch_x, batch_y, weight_bits, act_bits,
             pow2_weights=False):
    logits = cnn_apply(
        params, topo, batch_x, weight_bits=weight_bits, act_bits=act_bits,
        pow2_weights=pow2_weights,
    )
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, batch_y[:, None].long()).mean()


def train_step(params, opt_state, x, y, lr, *, topo, cfg: AdamWConfig,
               weight_bits=None, act_bits=None, pow2_weights=False):
    """One step: the loss and its gradient through ``cnn_apply``, clipping
    at global norm 1.0, one AdamW update at ``lr`` (a number, or a 0-d
    tensor used where it lives: a schedule's value on the card keeps the
    step free of host reads). Returns ``(params, opt_state, loss,
    grad_norm)``; the params come back as new tensors. Its phases are the
    spans ``repro_torch.train.forward``, ``.backward`` and ``.update``."""
    leaves, treedef = tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    with probe.span("repro_torch.train.forward"):
        loss = _loss_fn(treedef.unflatten(leaves), topo, x, y, weight_bits,
                        act_bits, pow2_weights)
    with probe.span("repro_torch.train.backward"):
        grads = treedef.unflatten(torch.autograd.grad(loss, leaves))
    with probe.span("repro_torch.train.update"):
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        params, opt_state = adamw_update(
            grads, opt_state, treedef.unflatten([p.detach() for p in leaves]), cfg, lr
        )
    return params, opt_state, loss.detach(), gnorm


class JittedTrainStep(cuda_graphs.JittedTrainStep):
    """``step(params, opt_state, x, y, step) -> (params, opt_state, loss,
    grad_norm)``, the training step as one captured executable per
    (topology, quant mode, batch shape): the counterpart of the
    reference's ``jax.jit`` of its local ``step_fn``
    (``repro.paper.train_cnn``), built by :func:`jit_train_step`.

    A ``cuda_graphs.JittedTrainStep`` of :func:`train_step` at
    ``lr=sched(step)`` on the batch ``{"x": x, "y": y}``, without
    donation, as the reference's jit donates nothing: the caller's trees
    are never written, and the trees a call returns stay valid after
    later calls (``ResilientTrainer`` restarts from the state it was
    given). The key is x's and y's shapes and dtypes and the params' and
    optimizer state's (the topology and the quant mode are the object's
    own); the step is never read on the host, and ``sched`` computes the
    learning rate from it on the device. The capture records the loss
    through ``cnn_apply`` (the plan compiled at capture, its weight bake
    recorded, so each replay bakes that step's weights), the gradient
    through the stream-conv groups' and the pow2 head's autograd
    Functions, clipping, ``sched(step)`` and AdamW, so the results are
    the eager step's bit for bit; a replay counts again the forward's
    stream-conv and pow2 launches its capture logged.
    """

    def __init__(self, topo: CNNTopology, cfg: AdamWConfig, sched: Callable, *,
                 weight_bits=None, act_bits=None, pow2_weights=False):
        self.sched = sched
        quant = dict(weight_bits=weight_bits, act_bits=act_bits, pow2_weights=pow2_weights)

        def fn(params, opt_state, batch, step):
            params, opt_state, loss, gnorm = train_step(
                params, opt_state, batch["x"], batch["y"], sched(step), topo=topo, cfg=cfg,
                **quant)
            return params, opt_state, {"loss": loss, "grad_norm": gnorm}

        super().__init__(fn, donate=False)

    def __call__(self, params, opt_state, x, y, step):
        params, opt_state, metrics = super().__call__(
            params, opt_state, {"x": torch.as_tensor(x), "y": torch.as_tensor(y)}, step)
        return params, opt_state, metrics["loss"], metrics["grad_norm"]


def jit_train_step(topo: CNNTopology, cfg: AdamWConfig, sched: Callable, *,
                   weight_bits=None, act_bits=None, pow2_weights=False) -> JittedTrainStep:
    """The jitted training step of ``topo`` under one quant mode: the
    counterpart of the reference's ``@jax.jit`` ``step_fn`` (loss,
    gradient, clipping, ``sched(step)`` and AdamW as one executable). A
    new object, which keeps one CUDA graph per batch shape it is called
    with, as the reference's closure keeps its executables."""
    return JittedTrainStep(topo, cfg, sched, weight_bits=weight_bits, act_bits=act_bits,
                           pow2_weights=pow2_weights)


def evaluate(params, topo, x, y, *, weight_bits=None, act_bits=None,
             pow2_weights=False, batch=256):
    """Classification accuracy over a split (on the params' device): one
    plan compiled for ``params``, the batches through ``plan(x)`` (on the
    card its graph, one per batch shape)."""
    dev = tree_flatten(params)[0][0].device
    correct = 0
    with torch.inference_mode():
        plan = compile_dhm(
            topo, params, device=dev,
            quant=QuantSpec(weight_bits=weight_bits, act_bits=act_bits,
                            pow2_weights=pow2_weights),
        )
        for i in range(0, x.shape[0], batch):
            logits = plan(_as_tensor(x[i : i + batch], dev, torch.float32))
            yb = _as_tensor(y[i : i + batch], dev)
            correct += int(torch.sum(torch.argmax(logits, -1) == yb))
    return correct / x.shape[0]


def train_cnn(
    topo: CNNTopology,
    *,
    steps: int = 400,
    batch_size: int = 128,
    peak_lr: float = 3e-3,
    seed: int = 0,
    weight_bits: Optional[int] = None,
    act_bits: Optional[int] = None,
    pow2_weights: bool = False,
    init_params: Optional[dict] = None,
    dataset=None,
    log_every: int = 100,
    verbose: bool = False,
    device=None,
) -> TrainedCNN:
    """Train ``topo`` for ``steps`` AdamW steps (weight decay 0.01, linear
    warmup over 20 steps then cosine from ``peak_lr``) on ``dataset`` (the
    synthetic task for ``seed`` if None), from ``init_params`` (a fresh
    ``init_cnn`` from ``seed + 1`` if None), on ``device`` (the card unless
    ``"cpu"``), each step through :func:`jit_train_step`. Batch indices
    come from ``np.random.default_rng(seed + 2)`` as in the reference."""
    dev = resolve_device(device)
    ds = dataset or make_image_dataset(
        hw=topo.square_input_hw(), channels=topo.input_channels, seed=seed
    )
    if init_params is None:
        init_params = init_cnn(torch.Generator().manual_seed(seed + 1), topo, device=dev)
    params = tree_map(lambda p: _as_tensor(p, dev, torch.float32), init_params)
    cfg = AdamWConfig(weight_decay=0.01)
    state = adamw_init(params, cfg)
    sched = linear_warmup_cosine(peak_lr, warmup_steps=20, total_steps=steps)
    x_train = _as_tensor(ds.x_train, dev, torch.float32)
    y_train = _as_tensor(ds.y_train, dev)
    n = x_train.shape[0]

    step_fn = jit_train_step(topo, cfg, sched, weight_bits=weight_bits,
                             act_bits=act_bits, pow2_weights=pow2_weights)
    rng = np.random.default_rng(seed + 2)
    history = []
    for s in range(steps):
        idx = torch.from_numpy(rng.integers(0, n, size=batch_size)).to(dev)
        params, state, loss, _ = step_fn(params, state, x_train[idx], y_train[idx], s)
        if s % log_every == 0 or s == steps - 1:
            history.append({"step": s, "loss": float(loss)})
            if verbose:
                print(f"[{topo.name}] step {s:4d} loss {float(loss):.4f}")
    acc = evaluate(
        params, topo, ds.x_test, ds.y_test, weight_bits=weight_bits,
        act_bits=act_bits, pow2_weights=pow2_weights,
    )
    return TrainedCNN(topo=topo, params=params, float_accuracy=acc, history=history)


def _cache_path(name: str) -> str:
    return os.path.join(RESULTS_DIR, "cnn", f"{name}.torch.pkl")


def topology_seed(name: str) -> int:
    """Deterministic per-topology training seed (the reference's): CIFAR-10
    and SVHN share one topology, so a single global seed would train them
    on the same data from the same init; deriving the seed from the name
    gives each named model its own dataset draw and init."""
    return zlib.crc32(name.encode("utf-8")) % (2**16)


def get_trained_cnn(name: str, *, steps: int = 400, force: bool = False,
                    device=None) -> TrainedCNN:
    """Train-or-load the named paper topology (cached artifact, written by
    this package only). A cache blob trained under another seed is a miss
    and is retrained."""
    dev = resolve_device(device)
    topo = PAPER_TOPOLOGIES[name]
    path = _cache_path(name)
    seed = topology_seed(name)
    if not force and os.path.exists(path):
        with open(path, "rb") as f:
            blob = pickle.load(f)
        if blob.get("seed") == seed:
            return TrainedCNN(
                topo=topo,
                params=tree_map(lambda a: torch.from_numpy(a).to(dev), blob["params"]),
                float_accuracy=blob["float_accuracy"],
                history=blob["history"],
            )
    trained = train_cnn(topo, steps=steps, seed=seed, device=dev)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(
            {
                "params": tree_map(lambda t: t.detach().cpu().numpy(), trained.params),
                "float_accuracy": trained.float_accuracy,
                "history": trained.history,
                "seed": seed,
            },
            f,
        )
    return trained
