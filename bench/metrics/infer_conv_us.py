"""The conv stages, device us a request: the self device time of the
spans ``repro_torch.dhm.stage`` (``CompiledDHM.features``: the stream-conv
kernels and what a stage runs besides, the frame's quantization left out)
in the plan graph's matched replays (``bench/phases.py``). Moves
``infer_frames_per_s``."""
from __future__ import annotations

from bench import phases


def read(r):
    s = phases.self_seconds(r, phases.PLAN, "repro_torch.dhm.stage")
    return None if s is None else 1e6 * s
