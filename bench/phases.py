"""The port's CUDA-graph phases in a traced window.

The port records each graph it captures (``repro_torch.cuda_graphs``
``graphs()``): its owner (``JittedForward``, the plan's graph;
``JittedTrainStep``, the train step's), its phase table ((span path,
device operations), ...) in capture order, each operation's name as the
device trace names it ("Memcpy" and "Memset" for copies and fills; ""
where libcuda gave no name), and the host seconds of its key's first
call. A replay's operations run in capture order on one stream, back to
back, with nothing of the caller's between them. So a replay is found
among the window's device operations (``Trace.device``, ordered by start)
as a run whose names are the record's, and each of its operations is
charged to its phase. A replay the profiler lost a record of does not
match: it is left out, and counted (the window's requests or steps less
the matches).

The copy into the plan's static input is the one operation a plan call
enqueues on the stream just before its replay (``engine.JittedForward``):
the operation before each matched replay, where that is a copy.

A program without the registry gives nothing to read: every reader here
returns None, and a metric that reads it is left out of the line.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Optional

COPY, FILL = "Memcpy", "Memset"
PLAN, TRAIN = "JittedForward", "JittedTrainStep"


def records() -> list:
    """The port's capture records, oldest first; [] where the port keeps
    none."""
    try:
        from repro_torch import cuda_graphs
    except ImportError:
        return []
    graphs = getattr(cuda_graphs, "graphs", None)
    return list(graphs()) if graphs is not None else []


def _key(name: str) -> str:
    if name.startswith(COPY):
        return COPY
    if name.startswith(FILL):
        return FILL
    return name


def _fits(key: str, op: str) -> bool:
    """Whether a trace operation (its key) is the record's operation
    ``op`` ("" stands for any kernel)."""
    return key == op or (op == "" and key not in (COPY, FILL))


def find(keys: list, ops) -> list:
    """The start of each run of ``keys`` that is a replay of ``ops``,
    left to right, runs not overlapping."""
    n, starts, i = len(ops), [], 0
    if n == 0:
        return starts
    while i + n <= len(keys):
        if _fits(keys[i], ops[0]) and all(_fits(keys[i + j], ops[j]) for j in range(1, n)):
            starts.append(i)
            i += n
        else:
            i += 1
    return starts


@dataclasses.dataclass
class Window:
    """One owner's graph in the traced window: its record, the device
    operations ordered by start ((name, start, end) each), the index of
    each matched replay's first operation, and the replays the window
    made (its requests or steps)."""

    record: object
    device: list
    starts: list
    expected: int

    @property
    def matched(self) -> int:
        return len(self.starts)

    def by_path(self) -> dict:
        """Device seconds of the matched replays by span path."""
        out: dict = {}
        for i in self.starts:
            at = i
            for path, n in self.record.phases:
                out[path] = out.get(path, 0.0) + sum(e - s for _, s, e in self.device[at:at + n])
                at += n
        return out

    def replay_seconds(self) -> float:
        n = self.record.n_ops
        return sum(e - s for i in self.starts for _, s, e in self.device[i:i + n])


_CACHE: dict = {}


def window(r, owner: str) -> Optional[Window]:
    """``owner``'s graph in the traced window of the readings ``r``: of its
    records, the one whose matched replays hold the most operations (the
    later of two that hold as many); None without a trace, a record or a
    match."""
    if r.trace is None:
        return None
    cached = _CACHE.get((owner, id(r.trace)))
    if cached is not None and cached[0] is r.trace:
        return cached[1]
    device = sorted(r.trace.device, key=lambda op: op[1])
    keys = [_key(name) for name, _, _ in device]
    best = None
    for rec in records():
        if rec.owner != owner or not rec.ops or not rec.phases:
            continue
        starts = find(keys, rec.ops)
        if starts and (best is None
                       or len(starts) * rec.n_ops >= best.matched * best.record.n_ops):
            best = Window(record=rec, device=device, starts=starts,
                          expected=int(r.work.get("requests", r.work.get("steps", 0))))
    _CACHE[(owner, id(r.trace))] = (r.trace, best)
    if best is not None:
        busy = r.trace.busy_s
        print(f"bench.phases: {owner} graph {best.record.id}: {best.matched} of "
              f"{best.expected} replays matched, {best.record.n_ops} operations each, "
              f"{best.replay_seconds():.6f} s of {busy:.6f} s busy in them", file=sys.stderr)
    return best


def self_seconds(r, owner: str, span: str) -> Optional[float]:
    """Device seconds a replay whose innermost span is ``span``."""
    w = window(r, owner)
    if w is None:
        return None
    paths = w.by_path()
    if not any(p.split("/")[-1] == span for p in paths):
        return None
    return sum(v for p, v in paths.items() if p.split("/")[-1] == span) / w.matched


def tree_seconds(r, owner: str, span: str) -> Optional[float]:
    """Device seconds a replay under ``span``, its children's included."""
    w = window(r, owner)
    if w is None:
        return None
    paths = w.by_path()
    if not any(span in p.split("/") for p in paths):
        return None
    return sum(v for p, v in paths.items() if span in p.split("/")) / w.matched


def stage_in_seconds(r) -> Optional[float]:
    """Device seconds of the copy into the plan's static input a request:
    the operation before each matched replay of the plan's graph, where it
    is a copy. A replay with no copy before it (a donated input, or other
    work on the stream) is left out and counted; None where none has one."""
    w = window(r, PLAN)
    if w is None:
        return None
    before = [w.device[i - 1] for i in w.starts if i > 0]
    copies = [op for op in before if _key(op[0]) == COPY]
    if len(copies) < w.matched:
        print(f"bench.phases: {w.matched - len(copies)} of {w.matched} matched replays "
              f"have no copy in before them", file=sys.stderr)
    if not copies:
        return None
    return sum(e - s for _, s, e in copies) / len(copies)


def first_call_seconds(r, owner: str) -> Optional[float]:
    """Host seconds of the first call of the key whose graph the window
    replays: the matched record's, else the owner's one record."""
    w = window(r, owner)
    if w is not None:
        rec = w.record
    else:
        own = [rec for rec in records() if rec.owner == owner]
        if len(own) != 1:
            return None
        rec = own[0]
    return rec.first_call_s if rec.first_call_s > 0 else None
