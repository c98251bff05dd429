"""The whole step's share of the card's float32 peak, in %: three times
the forward's FLOPs (``bench/count``) for the traced window's frames, at
67 TFLOP/s (TF32 off, the fake-quant forward in float32), over the traced
window. Moves ``train_frames_per_s``."""
from __future__ import annotations

from bench.count import cnn as count


def read(r):
    if r.trace is None or not r.trace.device or r.trace.window_s <= 0:
        return None
    flops = count.train_flops(r.cell.config["topology"], r.work["steps"] * r.work["batch"])
    return 100.0 * flops / r.peaks["fp32_flops_per_s"] / r.trace.window_s
