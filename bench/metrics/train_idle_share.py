"""The device's idle share of the traced window, in %: the time in which
no kernel, copy or memset ran (the union of their intervals, never their
sum). Moves ``train_frames_per_s``."""
from __future__ import annotations


def read(r):
    t = r.trace
    if t is None or not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
