"""The readings that the limits in ``bench/limits/`` were set from, apart
from the program's own: the control, and for the training cells the
faults a step can have.

- The control is the reference put in the program's place in the
  precision below the configuration's, judged as the program's outputs
  are, on the cell's own inputs. Inference: the configuration states a
  fixed-point width, on whose codes the integer convs and the float32
  head's sums are exact (TF32 holds the head's quantized operands exactly,
  so it is no step down here: ``tf32_head`` reads it), and the control is
  one bit fewer for weights and stream, over the logits of every pool
  batch (every distinct answer a window gives). Training: the configuration states float32 with TF32 off,
  and the control is TF32, as ``reference.cnn`` renders it with
  ``precision="tf32"``, over the checked steps.
- Training faults, planted in the reference in the program's place: half
  the batch left out (the loss the mean over the other half), and a step
  that returns its state unchanged.

    python3 bench/control.py --workload <cell> --seeds <n> [<n> ...]

on a machine with a card prints one JSON line per seed. The benchmark's
own runs never run this; ``bench/test_bench_control.py`` runs it at a
small size on the CPU.
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
from bench.correct import frames_outside, train_values  # noqa: E402
from bench.loops import infer_requests, train_steps  # noqa: E402
from bench.reference import cnn as reference  # noqa: E402


def one_bit_fewer(cfg: dict) -> dict:
    q = dict(cfg["infer_quant"])
    q["weight_bits"] -= 1
    q["act_bits"] -= 1
    return {**cfg, "infer_quant": q}


def infer_readings(cell) -> dict:
    """frames_outside of the control, one bit fewer, over every pool batch."""
    params, pool = infer_requests.make_inputs(cell)
    lower = one_bit_fewer(cell.config)
    outside = tf32 = 0
    for k in range(pool.shape[0]):
        ref = reference.int8_forward(cell.config, params, pool[k])
        outside += frames_outside(reference.int8_forward(lower, params, pool[k]), ref)
        head = reference.int8_forward(cell.config, params, pool[k], precision="tf32")
        tf32 += frames_outside(head, ref)
    frames = pool.shape[0] * pool.shape[1]
    return {"control": {"frames_outside": outside, "frames_compared": frames},
            "tf32_head": {"frames_outside": tf32, "frames_compared": frames}}


def _as_program(ref: dict) -> dict:
    """A reference's result as a loop hands the program's over."""
    return {"losses": ref["losses"],
            "m1": [(1.0 - 0.9) * g for g in ref["first_grad"]],
            "params": ref["params"]}


def train_readings(cell) -> dict:
    """The training numbers of the TF32 control, of half the batch left
    out, and of a step that returns its state unchanged."""
    cfg, mix = cell.config, cell.mix
    params0, x_all, y_all, rows = train_steps.make_inputs(cell)
    batches = []
    for _ in range(mix["checked_steps"]):
        idx = rows.next()
        batches.append((x_all[idx], y_all[idx]))
    p0 = reference.leaves(params0)
    ref = reference.qat_steps(cfg, mix, params0, batches)
    out = {}
    ctl = reference.qat_steps(cfg, mix, params0, batches, precision="tf32")
    out["control"] = train_values(_as_program(ctl), ref, p0)
    half = [(x[: x.shape[0] // 2], y[: y.shape[0] // 2]) for x, y in batches]
    out["half_batch"] = train_values(_as_program(reference.qat_steps(cfg, mix, params0, half)),
                                     ref, p0)
    unchanged = {"losses": ref["losses"], "m1": [torch.zeros_like(t) for t in p0],
                 "params": [t.detach() for t in p0]}
    out["state_unchanged"] = train_values(unchanged, ref, p0)
    return out


def readings(cell) -> dict:
    kind = cell.mix["kind"]
    return infer_readings(cell) if kind == "infer_requests" else train_readings(cell)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="control and fault readings of a cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
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
