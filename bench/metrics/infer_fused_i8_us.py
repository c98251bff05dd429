"""The single-layer int8 conv kernel, device us a request: the device time
of every ``sc_fused_i8_kernel`` launch (``csrc/stream_conv.cu``: the
column strips and output-channel slices of the layers the plan's launch
table sends to it) in the traced window, over its requests. None where
the table sends it no layer. Moves ``infer_frames_per_s``."""
from __future__ import annotations

import re

KERNEL = re.compile(r"\bsc_fused_i8_kernel\b")


def read(r):
    if r.trace is None or not r.work.get("fused_i8_layers") or not r.work["requests"]:
        return None
    busy = r.trace.device_seconds(lambda name: KERNEL.search(name) is not None)
    return 1e6 * busy / r.work["requests"] if busy > 0 else None
