"""The training entry's host time: the median of the host clock around
each ``JittedTrainStep`` call of the window (``paper/train_cnn.py`` over
``cuda_graphs.JittedTrainStep``: the trees copied in, the replay's
enqueue, the clones out). Moves ``train_frames_per_s``."""
from __future__ import annotations

import statistics


def read(r):
    xs = r.host_s.get("step")
    return 1e6 * statistics.median(xs) if xs else None
