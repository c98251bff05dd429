"""The single-layer int8 conv kernel's share of its roofline, in %: the
least time of the layers the plan's launch table sends to it
(``work["fused_i8_layers"]``), for the traced window's requests, over the
device time of its launches (``sc_fused_i8_kernel``). A layer's least
time is the larger of its operations at the int8 peak and of its bytes at
the memory's peak: its input codes read once (1 byte each) and its
float32 output written once (``bench/count``'s shapes). Moves
``infer_frames_per_s``."""
from __future__ import annotations

import re

from bench.count import cnn as count

KERNEL = re.compile(r"\bsc_fused_i8_kernel\b")


def layer_seconds(topo: dict, layer: int, frames: int, peaks: dict) -> float:
    """One layer's least time for ``frames`` frames on the int8 kernel."""
    shapes = count.conv_shapes(topo)
    c, n, k, hc, wc, ho, wo = shapes[layer]
    if layer:
        h_in, w_in = shapes[layer - 1][5:7]
    else:
        h_in, w_in, _ = count.input_hwc(topo)
    ops = 2.0 * c * n * k * k * hc * wc * frames
    moved = float(frames * (h_in * w_in * c + 4 * ho * wo * n))
    return max(ops / peaks["int8_ops_per_s"], moved / peaks["hbm_bytes_per_s"])


def read(r):
    if r.trace is None or not r.work.get("fused_i8_layers"):
        return None
    busy = r.trace.device_seconds(lambda name: KERNEL.search(name) is not None)
    if busy <= 0:
        return None
    topo, frames = r.cell.config["topology"], r.work["frames_per_request"]
    least = sum(layer_seconds(topo, li, frames, r.peaks) for li in r.work["fused_i8_layers"])
    return 100.0 * least * r.work["requests"] / busy
