"""The control reading that the ``logit_gap`` limit of a VGG cell
(``bench/limits/vgg16-q8.infer.json``) was set below, and the reference's
own cost.

The control is the reference put in the program's place in the precision
below the configuration's: the FC head's sums rounded to bfloat16
(``bench/reference/vgg.py``, ``precision="bf16"``), judged as the
program's logits are (``logit_gap``), over every pool batch of the cell's
own inputs. The 8-bit operands are exact in TF32 and bfloat16, so a step
down in the operands would read 0.

    python3 bench/control_vgg.py --workload vgg16-q8.infer --seeds <n> [<n> ...]

on a machine with a card prints one JSON line per seed: the control's
``logit_gap``, the seconds the reference's conv stage and head took over
the pool, and the card's peak memory while they ran.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

if __name__ == "__main__":
    sys.path[:0] = [str(Path(__file__).resolve().parents[1])]

from bench import harness  # noqa: E402
from bench.loops import infer_requests  # noqa: E402
from bench.loops.infer_requests_vgg import logit_gap  # noqa: E402
from bench.reference import vgg as reference  # noqa: E402


def readings(cell) -> dict:
    params, pool = infer_requests.make_inputs(cell)
    cfg, gaps, conv_s, head_s = cell.config, [], 0.0, 0.0
    if cell.on_card:
        torch.cuda.reset_peak_memory_stats(cell.device)
    for k in range(pool.shape[0]):
        t0 = time.perf_counter()
        feats = reference.features(cfg, params, pool[k])
        cell.sync()
        t1 = time.perf_counter()
        ref = reference.head(cfg, params, feats)
        cell.sync()
        head_s += time.perf_counter() - t1
        conv_s += t1 - t0
        gaps.append(logit_gap(reference.head(cfg, params, feats, precision="bf16"), ref))
    peak = torch.cuda.max_memory_allocated(cell.device) if cell.on_card else 0
    return {"control": {"logit_gap": min(gaps), "logit_gap_max": max(gaps),
                        "batches": len(gaps)},
            "reference": {"conv_s": conv_s, "head_s": head_s, "memory_peak_bytes": peak}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="control reading of a VGG cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control_vgg: no CUDA card", file=sys.stderr)
        return 2
    spec = harness.load_spec()
    for seed in args.seeds:
        t = time.perf_counter()
        cell = harness.make_cell(spec, args.workload, seed=seed, seconds=0.0, trace=False,
                                 device="cuda:0", t_start=t)
        line = {"workload": args.workload, "seed": seed, **readings(cell),
                "seconds": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
