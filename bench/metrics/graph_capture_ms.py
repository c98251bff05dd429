"""The first call of the window's graph key, host ms: warm-up, release
(the train step's), capture and the call around them, from the port's
capture record (``cuda_graphs.graphs``; ``bench/phases.py``). Inside
``setup_s``, which it moves."""
from __future__ import annotations

from bench import phases


def read(r):
    owner = phases.TRAIN if "steps" in r.work else phases.PLAN
    s = phases.first_call_seconds(r, owner)
    return None if s is None else 1e3 * s
