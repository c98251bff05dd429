"""The whole request's share of the card's peak, in %: the least compute
time of the traced window's requests (``bench/count``: the conv layers'
operations at the integer or float32 peak, the head's FLOPs at the float32
peak) over the traced window. Moves ``infer_frames_per_s``."""
from __future__ import annotations

from bench.count import cnn as count


def read(r):
    if r.trace is None or not r.trace.device or r.trace.window_s <= 0:
        return None
    cfg = r.cell.config
    work = count.infer_work(cfg["topology"], r.work["frames_per_request"],
                            int8=bool(cfg["infer_quant"].get("int8_compute")))
    return 100.0 * work.compute_seconds(r.peaks) * r.work["requests"] / r.trace.window_s
