"""The train step's forward, device ms a step: the device time of the
span ``repro_torch.train.forward`` (``paper/train_cnn.py`` ``train_step``:
the loss through ``cnn_apply``, the weights' bake and the ``dhm.*`` spans
within) in the train graph's matched replays (``bench/phases.py``). Moves
``train_frames_per_s``."""
from __future__ import annotations

from bench import phases


def read(r):
    s = phases.tree_seconds(r, phases.TRAIN, "repro_torch.train.forward")
    return None if s is None else 1e3 * s
