"""End-to-end LM training on the PyTorch/CUDA port: data pipeline ->
train step -> AdamW -> checkpoint/restart, with fault tolerance and
straggler monitoring.

The counterpart of ``examples/train_lm.py``, with the same flags and
``--device`` (the card unless ``cpu``). Its jitted step is a
``JittedTrainStep`` of :func:`make_train_step`'s eager step, nothing
donated (the trainer restarts from the trees it was given): on the card
one CUDA graph, its learning rate ``sched(step)`` computed there from the
step count; on the CPU the eager step. Checkpoints go to ``--ckpt-dir``
(default ``$REPRO_RESULTS_DIR/train_lm_ckpt``, ``results/`` unset); a run
resumes from the newest checkpoint there.

    PYTHONPATH=src python examples/torch/train_lm.py --preset smoke
    PYTHONPATH=src python examples/torch/train_lm.py --preset 20m --steps 200
    PYTHONPATH=src python examples/torch/train_lm.py --device cpu --inject-failure-at 7
"""
import argparse
import os
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.data import TokenStreamConfig, synthetic_token_batches
from repro_torch.launch.steps import JittedTrainStep
from repro_torch.models import transformer as T
from repro_torch.models.accounting import param_count
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    linear_warmup_cosine,
)
from repro_torch.runtime import FaultInjector, ResilientTrainer, StragglerMonitor
from repro_torch.tree_util import tree_flatten

PRESETS = {
    # name: (layers, d_model, heads, kv, d_ff, vocab, seq, batch)
    # The synthetic affine-recurrence task is a vocab-sized lookup, so the
    # vocab is kept small enough that each embedding row gets O(100s) of
    # gradient updates within a few-hundred-step run.
    "smoke": (2, 128, 4, 2, 256, 512, 64, 8),
    "20m": (8, 384, 8, 4, 1024, 2048, 256, 8),
    "100m": (12, 768, 12, 4, 2048, 32768, 512, 8),
}


def make_cfg(preset: str) -> ArchConfig:
    layers, d, h, kv, ff, v, _, _ = PRESETS[preset]
    return ArchConfig(name=f"lm-{preset}", family="dense", n_layers=layers, d_model=d,
                      n_heads=h, n_kv_heads=kv, d_ff=ff, vocab_size=v, dtype="float32",
                      remat="none")


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, sched):
    """The example's eager train step ``(params, opt, batch, step) ->
    (params, opt, (loss, grad norm))``, its learning rate ``sched(step)``
    on the step's device."""

    def train_step(params, opt, batch, step):
        leaves, treedef = tree_flatten(params)
        leaves = [t.detach().requires_grad_() for t in leaves]
        loss, _ = T.train_loss(treedef.unflatten(leaves), cfg, batch,
                               vocab_chunk=min(8192, cfg.vocab_size))
        grads = treedef.unflatten(list(torch.autograd.grad(loss, leaves)))
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        params, opt = adamw_update(grads, opt, params, opt_cfg, sched(step))
        return params, opt, (loss.detach(), gnorm)

    return train_step


def main(argv=None) -> JittedTrainStep:
    """Run the example; returns its jitted train step (for a caller that
    checks its captures)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=PRESETS, default="smoke")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        os.environ.get("REPRO_RESULTS_DIR", "results"), "train_lm_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--inject-failure-at", type=int, default=-1,
                    help="simulate a node failure at this step")
    ap.add_argument("--device", default="cuda", help="the card (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    cfg = make_cfg(args.preset)
    _, _, _, _, _, _, seq, batch = PRESETS[args.preset]
    print(f"model: {cfg.n_layers}L d={cfg.d_model} -> {param_count(cfg) / 1e6:.1f}M params "
          f"on {dev.type}")
    stream_cfg = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=seq, batch_size=batch)
    print(f"stream loss floor: {stream_cfg.loss_floor:.3f} nats")

    params = T.init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    opt_cfg = AdamWConfig(weight_decay=0.01)
    opt = adamw_init(params, opt_cfg)
    sched = linear_warmup_cosine(1e-3, warmup_steps=20, total_steps=args.steps)

    train_step = JittedTrainStep(make_train_step(cfg, opt_cfg, sched), donate=False)

    def batch_fn(step):
        # Deterministic per-step stream => bitwise replay after restart.
        it = synthetic_token_batches(stream_cfg, seed=1000 + step)
        return torch.from_numpy(next(it)["tokens"]).to(dev)

    tokens_per_step = batch * seq
    losses = []

    def step_fn(state, tokens, step):
        params, opt = state
        t0 = time.perf_counter()
        params, opt, (loss, gnorm) = train_step(params, opt, {"tokens": tokens}, step)
        loss = float(loss)  # waits for the step
        losses.append(loss)
        dt = time.perf_counter() - t0
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {loss:.4f} gnorm {float(gnorm):.2f} "
                  f"{tokens_per_step / dt:.0f} tok/s", flush=True)
        return (params, opt), {"loss": loss}

    injector = (FaultInjector(fail_at_steps=(args.inject_failure_at,))
                if args.inject_failure_at >= 0 else None)
    trainer = ResilientTrainer(step_fn, batch_fn, CheckpointManager(args.ckpt_dir, keep=2),
                               ckpt_every=args.ckpt_every, straggler=StragglerMonitor(),
                               fault_injector=injector)
    t0 = time.perf_counter()
    (params, opt), _ = trainer.run((params, opt), num_steps=args.steps)
    wall = time.perf_counter() - t0
    # A rerun over a finished run's checkpoints resumes past the last step.
    final = f"{losses[-1]:.4f}" if losses else "- (resumed past the last step)"
    print(f"done: {args.steps} steps in {wall:.1f}s "
          f"({args.steps * tokens_per_step / wall:.0f} tok/s), "
          f"final loss {final} (floor {stream_cfg.loss_floor:.3f}), "
          f"restarts={trainer.restarts}, stragglers={len(trainer.straggler.flagged)}")
    print("OK")
    return train_step


if __name__ == "__main__":
    main()
