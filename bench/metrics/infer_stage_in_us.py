"""The copy of a request's frames into the plan graph's static input,
device us a request (``engine.JittedForward`` makes it just before its
replay): the copy just before each matched replay (``bench/phases.py``).
Moves ``infer_frames_per_s``."""
from __future__ import annotations

from bench import phases


def read(r):
    s = phases.stage_in_seconds(r)
    return None if s is None else 1e6 * s
