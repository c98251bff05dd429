"""The plan entry's host time: the median of the host clock around each
``plan(x)`` call of the window (``CompiledDHM.__call__`` through
``engine.JittedForward``: the copy into the static input, the replay's
enqueue and the output's clone), the enqueue alone. Moves
``infer_p95_ms``."""
from __future__ import annotations

import statistics


def read(r):
    xs = r.host_s.get("enqueue")
    return 1e6 * statistics.median(xs) if xs else None
