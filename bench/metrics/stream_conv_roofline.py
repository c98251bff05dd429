"""The stream-conv kernels' share of their roofline, in %: the conv
layers' least time for the traced window's requests (``bench/count``:
their operations at the integer or float32 peak, or their input read once
and features written once at the memory's peak, the larger) over the
device time of the kernels these patterns name (``csrc/stream_conv.cu``).
Moves ``infer_frames_per_s``."""
from __future__ import annotations

import re

from bench.count import cnn as count

KERNELS = re.compile(r"\bsc_(pyramid|fused)(_i8)?_kernel\b")


def read(r):
    if r.trace is None:
        return None
    busy = r.trace.device_seconds(lambda name: KERNELS.search(name) is not None)
    if busy <= 0:
        return None
    cfg = r.cell.config
    work = count.infer_work(cfg["topology"], r.work["frames_per_request"],
                            int8=bool(cfg["infer_quant"].get("int8_compute")))
    return 100.0 * work.conv_seconds(r.peaks) * r.work["requests"] / busy
