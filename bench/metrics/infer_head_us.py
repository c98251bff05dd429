"""The FC head, device us a request: the self device time of the span
``repro_torch.dhm.head`` (``engine.forward``: the head's GEMMs and their
epilogue, bias, tanh and fake-quant) in the plan graph's matched replays
(``bench/phases.py``). Moves ``infer_frames_per_s``."""
from __future__ import annotations

from bench import phases


def read(r):
    s = phases.self_seconds(r, phases.PLAN, "repro_torch.dhm.head")
    return None if s is None else 1e6 * s
