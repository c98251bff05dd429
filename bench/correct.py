"""The comparison that decides ``correct``.

Each number compared has a limit of its own, in ``bench/limits/<cell>.json``
(set from the readings ``PERF.md`` gives). A run is correct when every
number lies at or under its limit; NaN never does.

Inference cells: every sampled request's logits, as they reached the
host, against the reference's (:func:`bench.reference.cnn.int8_forward`),
which are exact in the configuration's arithmetic: a frame is outside
when any logit differs from the reference's by any amount.
``frames_outside`` counts them, and ``requests_unanswered`` counts
requests issued in the window whose logits never arrived.

Training cells: the program's first steps against the reference's, from
the same weights on the same batches. ``loss_gap``: the largest relative
gap of a step's loss. ``grad_gap`` and ``update_gap``, by the worst leaf:
the gap between the program's and the reference's norms of the first
clipped gradient (the program's worked out from AdamW's first moment after
one step, m / (1 - b1)) and of the parameters' change over the checked
steps, each over the larger of the reference's norm of that leaf and of
the median leaf. Leaves whose reference gradient is under a thousandth of
the median leaf's are left out of ``update_gap``: they move by round-off
alone.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
from pathlib import Path

import torch

LIMITS_DIR = Path(__file__).resolve().parent / "limits"
ADAM_B1 = 0.9


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return not math.isnan(self.value) and self.value <= self.limit


def load_limits(cell: str) -> dict:
    with open(LIMITS_DIR / f"{cell}.json") as f:
        return json.load(f)["limits"]


def checks(values: dict, limits: dict) -> list:
    return [Check(name, float(values[name]), float(limits[name])) for name in limits]


def frames_outside(logits: torch.Tensor, ref: torch.Tensor) -> int:
    """Frames with any logit not equal to the reference's (NaN never is)."""
    return int((~(logits.to(ref.device) == ref).all(dim=1)).sum())


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().to(torch.float64).cpu()))


def norm_gap(prog: list, ref: list, keep=None) -> float:
    """The worst leaf's |‖prog‖ - ‖ref‖| over max(‖ref‖, the median leaf's ‖ref‖)."""
    pn = [_norm(t) for t in prog]
    rn = [_norm(t) for t in ref]
    med = statistics.median(rn)
    keep = keep or [True] * len(rn)
    gaps = [abs(p - r) / max(r, med) for p, r, k in zip(pn, rn, keep) if k]
    if any(math.isnan(g) for g in gaps):
        return math.nan
    return max(gaps) if gaps else 0.0


def train_values(prog: dict, ref: dict, params0: list) -> dict:
    """``prog``: "losses" (floats), "m1" (AdamW's first moment after step 1)
    and "params" (after the checked steps), leaves in reference order;
    ``ref``: :func:`bench.reference.cnn.qat_steps`'s result; ``params0``
    the leaves both started from."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    if any(math.isnan(p) for p in prog["losses"]):
        loss_gap = math.nan
    grads = [m.to(torch.float64) / (1.0 - ADAM_B1) for m in prog["m1"]]
    ref_g = [_norm(g) for g in ref["first_grad"]]
    med = statistics.median(ref_g)
    moved = [g >= 1e-3 * med for g in ref_g]
    p0 = [t.to(torch.float64).cpu() for t in params0]
    d_prog = [t.to(torch.float64).cpu() - a for t, a in zip(prog["params"], p0)]
    d_ref = [t.to(torch.float64).cpu() - a for t, a in zip(ref["params"], p0)]
    return {
        "loss_gap": loss_gap,
        "grad_gap": norm_gap(grads, ref["first_grad"]),
        "update_gap": norm_gap(d_prog, d_ref, moved),
    }
