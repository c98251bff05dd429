"""Quickstart on the PyTorch/CUDA port: build a small LM, train a few
steps, apply the paper's pow2 (constant-specialized-multiplier)
quantization, and serve tokens.

The counterpart of ``examples/quickstart.py``, plus ``--device`` (the
card unless ``cpu``). Its jitted step is a ``JittedTrainStep`` of the
eager step, nothing donated: on the card one CUDA graph, replayed from
the second step on; on the CPU the eager step.

    PYTHONPATH=src python examples/torch/quickstart.py
    PYTHONPATH=src python examples/torch/quickstart.py --device cpu
"""
import argparse
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.core.quant.pow2 import pow2_codes
from repro_torch.data import TokenStreamConfig, synthetic_token_batches
from repro_torch.launch.steps import JittedTrainStep
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, clip_by_global_norm
from repro_torch.tree_util import tree_flatten


def make_cfg():
    """A reduced qwen2.5 — same family, small enough for a quick run."""
    return get_arch("qwen2.5-3b").scaled_down(n_layers=4, d_model=128, vocab_size=512)


def make_train_step(cfg, opt_cfg: AdamWConfig):
    """The quickstart's eager train step ``(params, opt, batch, step) ->
    (params, opt, loss)`` at a constant learning rate of 1e-3 (``step``
    unused)."""

    def train_step(params, opt, batch, _step):
        leaves, treedef = tree_flatten(params)
        leaves = [t.detach().requires_grad_() for t in leaves]
        loss, _ = T.train_loss(treedef.unflatten(leaves), cfg, batch, vocab_chunk=256)
        grads, _ = clip_by_global_norm(
            treedef.unflatten(list(torch.autograd.grad(loss, leaves))), 1.0)
        params, opt = adamw_update(grads, opt, params, opt_cfg, 1e-3)
        return params, opt, loss.detach()

    return train_step


def main(argv=None) -> JittedTrainStep:
    """Run the quickstart; returns its jitted train step (for a caller
    that checks its captures)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="the card (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    cfg = make_cfg()
    print(f"arch={cfg.name} (reduced): {cfg.n_layers}L d={cfg.d_model} on {dev.type}")

    params = T.init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    opt_cfg = AdamWConfig(weight_decay=0.01)
    opt = adamw_init(params, opt_cfg)

    stream_cfg = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=64, batch_size=16)
    batches = synthetic_token_batches(stream_cfg, seed=0)
    print(f"token stream loss floor: {stream_cfg.loss_floor:.3f} nats")

    step = JittedTrainStep(make_train_step(cfg, opt_cfg), donate=False)
    t0 = time.perf_counter()
    for i in range(30):
        tokens = torch.from_numpy(next(batches)["tokens"]).to(dev)
        params, opt, loss = step(params, opt, {"tokens": tokens})
        if i % 10 == 0 or i == 29:
            print(f"step {i:3d} loss {float(loss):.3f}")
    print(f"trained 30 steps in {time.perf_counter() - t0:.1f}s")

    # --- The paper's tactic: constant-specialize the weights (pow2 codes).
    w = params["stack"]["units"][0]["ffn"]["up"]["w"]
    codes, _ = pow2_codes(w[0], channel_axis=1)
    nz = float((codes == 0).float().mean())
    print(f"pow2-quantized ffn/up: {100 * nz:.1f}% zero codes, "
          f"4 bits/weight (4x bandwidth saving vs bf16)")

    # --- Serve: prefill + a few greedy decode steps.
    prompt = torch.from_numpy(next(batches)["tokens"]).to(dev)[:2, :16]
    logits, cache = T.prefill(params, cfg, prompt, max_len=32)
    toks = []
    tok = logits.argmax(-1, keepdim=True)
    for t in range(8):
        logits, cache = T.decode_step(params, cfg, tok, cache, 16 + t)
        tok = logits.argmax(-1, keepdim=True)
        toks.append(int(tok[0, 0]))
    print("greedy continuation:", toks)
    print("OK")
    return step


if __name__ == "__main__":
    main()
