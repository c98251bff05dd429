"""Spatial mapping of a DPN onto a TPU mesh — the DHM act itself.

A verbatim copy of ``repro.core.dhm.mapping`` (pure Python): the port keeps its own
copy so that it imports nothing of the JAX package.

On the FPGA every actor gets private silicon and throughput is set by the
clock. On a TPU mesh the analogue is: partition the (topologically ordered)
layer graph into S contiguous *stages*, assign each stage a private mesh
sub-slice, and stream µbatches through the stages. Steady-state throughput
is set by the slowest stage (the "critical actor"), so the mapper solves the
classic linear-partition problem: minimize max stage cost.

Exact DP (O(L^2 * S)) — L is layer count (<=100 here), so exactness is free.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class StageAssignment:
    """Contiguous stage partition: stage s owns layers
    [boundaries[s], boundaries[s+1])."""

    n_layers: int
    boundaries: tuple  # len = n_stages + 1; [0, ..., n_layers]
    stage_costs: tuple

    @property
    def n_stages(self) -> int:
        return len(self.boundaries) - 1

    @property
    def bottleneck(self) -> float:
        return max(self.stage_costs)

    def stage_of_layer(self, layer: int) -> int:
        for s in range(self.n_stages):
            if self.boundaries[s] <= layer < self.boundaries[s + 1]:
                return s
        raise ValueError(f"layer {layer} out of range")

    def layers_of_stage(self, stage: int):
        return range(self.boundaries[stage], self.boundaries[stage + 1])


def partition_stages(costs: Sequence[float], n_stages: int) -> StageAssignment:
    """Optimal contiguous partition of per-layer costs into n_stages,
    minimizing the max per-stage cost (dynamic programming)."""
    L = len(costs)
    if n_stages < 1:
        raise ValueError("n_stages must be >= 1")
    if n_stages > L:
        raise ValueError(f"more stages ({n_stages}) than layers ({L})")
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + float(c))

    def seg(i: int, j: int) -> float:  # cost of layers [i, j)
        return prefix[j] - prefix[i]

    INF = float("inf")
    # dp[s][j] = best bottleneck using s stages for first j layers
    dp = [[INF] * (L + 1) for _ in range(n_stages + 1)]
    cut = [[0] * (L + 1) for _ in range(n_stages + 1)]
    dp[0][0] = 0.0
    for s in range(1, n_stages + 1):
        for j in range(s, L + 1):
            # last stage covers [i, j)
            for i in range(s - 1, j):
                cand = max(dp[s - 1][i], seg(i, j))
                if cand < dp[s][j]:
                    dp[s][j] = cand
                    cut[s][j] = i
    bounds = [L]
    j = L
    for s in range(n_stages, 0, -1):
        j = cut[s][j]
        bounds.append(j)
    bounds.reverse()
    stage_costs = tuple(
        seg(bounds[s], bounds[s + 1]) for s in range(n_stages)
    )
    return StageAssignment(
        n_layers=L, boundaries=tuple(bounds), stage_costs=stage_costs
    )


def partition_greedy_budget(n: int, fits) -> tuple:
    """Maximal contiguous left-to-right partition of ``n`` layers under a
    hard per-run feasibility bound.

    ``fits(i, j)`` says whether the run [i, j) is feasible as one group.
    Each run is grown while feasible and closed at the first infeasible
    extension; singleton runs are always allowed (they fall back to the
    caller's per-layer path). This is the dual of ``partition_stages``:
    maximal groups under a hard bound (the fusion planner's VMEM budget)
    instead of balanced groups minimizing the max cost. Greedy is optimal
    for "fewest groups" here because feasibility is monotone in the run
    length (a sub-run of a feasible run is feasible).

    Returns a tuple of (start, end) half-open index pairs covering
    [0, n).
    """
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    runs = []
    i = 0
    while i < n:
        j = i + 1
        while j < n and fits(i, j + 1):
            j += 1
        runs.append((i, j))
        i = j
    return tuple(runs)


@dataclasses.dataclass(frozen=True)
class BalanceReport:
    assignment: StageAssignment
    n_microbatches: int

    @property
    def perfect_stage_cost(self) -> float:
        return sum(self.assignment.stage_costs) / self.assignment.n_stages

    @property
    def imbalance(self) -> float:
        """bottleneck / perfect (1.0 = perfectly balanced)."""
        return self.assignment.bottleneck / max(1e-12, self.perfect_stage_cost)

    @property
    def bubble_fraction(self) -> float:
        """GPipe fill/drain bubble: (S-1) / (m + S - 1)."""
        s = self.assignment.n_stages
        return (s - 1) / (self.n_microbatches + s - 1)

    @property
    def pipeline_efficiency(self) -> float:
        """Fraction of ideal (all-devices-busy) throughput achieved."""
        return (1.0 - self.bubble_fraction) / self.imbalance


def balance_report(
    costs: Sequence[float], n_stages: int, n_microbatches: int
) -> BalanceReport:
    return BalanceReport(
        assignment=partition_stages(costs, n_stages),
        n_microbatches=n_microbatches,
    )
