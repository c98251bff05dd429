"""The frame's quantization to codes, device us a request: the self
device time of the span ``repro_torch.dhm.quantize`` (``stream_conv/ops.py``
``_as_codes``) in the plan graph's matched replays (``bench/phases.py``).
Moves ``infer_frames_per_s``."""
from __future__ import annotations

from bench import phases


def read(r):
    s = phases.self_seconds(r, phases.PLAN, "repro_torch.dhm.quantize")
    return None if s is None else 1e6 * s
