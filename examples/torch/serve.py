"""Batched LM serving on the PyTorch/CUDA port: prefill a batch of
prompts, decode with greedy or temperature sampling, optionally with
pow2-packed ("constant-specialized") weights for every linear layer —
the paper's tactic as an LM serving feature (4 bits/weight).

The counterpart of ``examples/serve.py``, with the same flags and
``--device`` (the card unless ``cpu``). Decode runs the jitted step
(``launch/steps.py`` ``jit_decode_step`` with the cache donated: one CUDA
graph of the whole step on the card, replayed each token), the position
a device tensor advanced in place; the greedy ``argmax`` and the
temperature sampling run outside it. Times are on the host clock after
the card has finished (``torch.cuda.synchronize``).

    PYTHONPATH=src python examples/torch/serve.py --batch 4 --new-tokens 16
    PYTHONPATH=src python examples/torch/serve.py --pow2
"""
import argparse
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.launch.steps import jit_decode_step
from repro_torch.models import transformer as T
from repro_torch.models.layers import pack_params_pow2
from repro_torch.tree_util import tree_leaves


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--pow2", action="store_true",
                    help="serve with pow2-packed weights (paper tactic)")
    ap.add_argument("--device", default="cuda", help="the card (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cfg = get_arch(args.arch).scaled_down(n_layers=4, d_model=128, vocab_size=1024)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    if args.pow2:
        n_before = _nbytes(params["stack"])
        params = dict(params, stack=pack_params_pow2(params["stack"]))
        n_after = _nbytes(params["stack"])
        print(f"pow2-packed stack: {n_before / 1e6:.1f} MB -> "
              f"{n_after / 1e6:.1f} MB ({n_before / n_after:.2f}x)")

    gen = torch.Generator().manual_seed(1)
    b, p_len = args.batch, args.prompt_len
    prompts = torch.randint(0, cfg.vocab_size, (b, p_len), generator=gen).to(dev)
    max_len = p_len + args.new_tokens + 1

    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = T.prefill(params, cfg, prompts, max_len=max_len)
        sync()
        prefill_s = time.perf_counter() - t0
        print(f"prefill: batch={b} len={p_len} in {prefill_s * 1e3:.0f} ms "
              f"({b * p_len / prefill_s:.0f} tok/s) on {dev.type}")

        sample_gen = torch.Generator().manual_seed(2)
        tok = logits.argmax(-1, keepdim=True)
        out_tokens = [tok]
        decode = jit_decode_step(cfg)
        pos = torch.full((), p_len, dtype=torch.long, device=dev)
        t0 = time.perf_counter()
        for _ in range(args.new_tokens):
            logits, cache = decode(params, cache, tok, pos)
            pos.add_(1)
            if args.temperature > 0:
                probs = torch.softmax(logits.float() / args.temperature, dim=-1).cpu()
                tok = torch.multinomial(probs, 1, generator=sample_gen).to(dev)
            else:
                tok = logits.argmax(-1, keepdim=True)
            out_tokens.append(tok)
        sync()
        decode_s = time.perf_counter() - t0
    seqs = torch.cat(out_tokens, dim=1)
    print(f"decode: {args.new_tokens} tokens x {b} seqs in "
          f"{decode_s * 1e3:.0f} ms ({b * args.new_tokens / decode_s:.1f} tok/s)")
    print("sample continuation:", [int(t) for t in seqs[0][:12]])
    print("OK")


if __name__ == "__main__":
    main()
