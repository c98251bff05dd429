"""The head's GEMMs' share of their roofline, in %: the FC head's float32
FLOPs for the traced window's requests (``bench/count``) at the float32
peak (TF32 off), over the device time of the cuBLAS kernels these
patterns name (``compiler._emit_head``'s ``torch.matmul``). Moves
``infer_frames_per_s``."""
from __future__ import annotations

import re

from bench.count import cnn as count

KERNELS = re.compile(r"gemm|gemv|splitKreduce", re.IGNORECASE)
NOT = re.compile(r"\bsc_")


def read(r):
    if r.trace is None:
        return None
    busy = r.trace.device_seconds(
        lambda name: KERNELS.search(name) is not None and NOT.search(name) is None)
    if busy <= 0:
        return None
    cfg = r.cell.config
    work = count.infer_work(cfg["topology"], r.work["frames_per_request"],
                            int8=bool(cfg["infer_quant"].get("int8_compute")))
    return 100.0 * work.head_seconds(r.peaks) * r.work["requests"] / busy
