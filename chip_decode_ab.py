"""The eager LM decode step's time on an NVIDIA card, for one tree of the port.

    python3 chip_decode_ab.py [--src DIR] [--tag NAME] [--iters N]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
so two trees can be timed in one call on one card: unpack the other
commit with ``git archive`` into a git-ignored directory and run, e.g.,
parent, change, change, parent:

    python3 chip_decode_ab.py --src build/parent/src --tag parent
    python3 chip_decode_ab.py --tag change

For falcon-mamba-7b, recurrentgemma-9b and qwen2.5-3b at full width and
depth in bf16 (random weights from seed 0, drawn on the card), B=4: a
prefill of a 512-token prompt, then ``decode_step(params, cfg, token,
cache, 512)`` (the position a host int, as every tree takes it) on the
same inputs: the mean ms of a call on CUDA events and on the host clock
(``--iters`` calls, then a synchronize), and under the profiler the
kernels a step and the card's busy ms against the host clock of the same
profiled calls. Prints one line per model and, last, the card's name and
power limit from ``nvidia-smi``; each line is also a JSON object. Exits
2 without a card. Imports nothing of JAX and nothing of the reference
package.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ARCHS = ("falcon-mamba-7b", "recurrentgemma-9b", "qwen2.5-3b")
BATCH, PROMPT, NEW = 4, 512, 32
SEED = 0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parent / "src"))
    ap.add_argument("--tag", default="this tree")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("chip_decode_ab: no CUDA device is available", file=sys.stderr)
        sys.exit(2)
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    for name in ARCHS:
        cfg = get_arch(name)
        params = T.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg)
        toks = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                             generator=torch.Generator(device=dev).manual_seed(SEED + 1),
                             device=dev)
        with torch.no_grad():
            logits, cache = T.prefill(params, cfg, toks, max_len=PROMPT + NEW)
            tok = logits.argmax(-1, keepdim=True)

            def step():
                return T.decode_step(params, cfg, tok, cache, PROMPT)

            for _ in range(2):
                step()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(args.iters):
                step()
            end.record()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / args.iters
            events_ms = start.elapsed_time(end) / args.iters
            reps = 2
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(reps):
                    step()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        busy_ms, kernels = 0.0, 0
        for evt in prof.key_averages():
            if not str(evt.device_type).endswith("CUDA"):
                continue
            us = getattr(evt, "self_device_time_total", None)
            busy_ms += (evt.self_cuda_time_total if us is None else us) / 1e3 / reps
            kernels += evt.count // reps
        rec = {"tree": args.tag, "arch": name, "batch": BATCH, "events_ms": events_ms,
               "host_ms": host_ms, "iters": args.iters, "kernels": kernels,
               "busy_ms": busy_ms, "profiled_wall_ms": wall_ms, "card": smi}
        print(f"[ab] {args.tag}: {name} eager decode_step B={BATCH} bf16 {events_ms:.3f} ms on "
              f"CUDA events, {host_ms:.3f} ms host clock ({args.iters} calls); under the "
              f"profiler {kernels} kernels, busy {busy_ms:.3f} of {wall_ms:.3f} ms ({smi})")
        print(json.dumps(rec))
        del params, cache, logits, tok, toks
        torch.cuda.empty_cache()
    print(f"[ab] card: {smi}")


if __name__ == "__main__":
    main()
