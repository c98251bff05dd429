"""The train step's backward, device ms a step: the self device time of
the span ``repro_torch.train.backward`` (``torch.autograd.grad``: the
stream-conv groups' backward on PyTorch's convolution, the head's) in the
train graph's matched replays (``bench/phases.py``). Moves
``train_frames_per_s``."""
from __future__ import annotations

from bench import phases


def read(r):
    s = phases.self_seconds(r, phases.TRAIN, "repro_torch.train.backward")
    return None if s is None else 1e3 * s
