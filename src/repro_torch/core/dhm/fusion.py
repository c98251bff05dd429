"""VMEM-budget-aware fusion planner: DPN layers -> fusion groups.

A copy of ``repro.core.dhm.fusion`` with the reference's planner and its
budget kept as they are, so the port's plans have the same fusion groups
and ``block_rows`` as the reference's. (A Hopper cost model, against the
232,448 B of shared memory a block may use, is later work; the pyramid
kernel raises on a group whose slabs exceed it.)

The source paper's direct-hardware-mapping premise is that the whole CNN
graph executes as one on-chip dataflow pipeline — intermediate feature
maps never round-trip through external memory. The per-layer compiled
plan broke that property at every layer boundary (each stage was one
conv layer's kernel call, its output written to and re-read from HBM).
This planner restores it as a *compiler decision*: walk the DPN's conv
layers in order and greedily grow contiguous **fusion groups**, where a
group of layers is streamed through ONE fused pyramid kernel
(``stream_conv_pyramid``) with all inter-layer slabs VMEM-resident.

A candidate group is costed with the composed-halo geometry
(``halo.group_geometry`` + ``halo.working_set_bytes``): per block of
final-output rows, the working set is the resident input frame, every
layer's halo'd input slab, tap operands, conv/pooled slabs, and the
group's weights. The planner picks the largest block size whose working
set fits the budget (whole-frame first, then halving); if even
one-row blocks do not fit — or a shape the pyramid kernel cannot lower
appears — the group stops growing and the layer falls back to today's
single-layer stage (which has its own channel/width blocking). Singleton
groups are therefore always legal: with a zero budget the plan is
exactly the per-layer plan.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.core.dhm.mapping import partition_greedy_budget
from repro_torch.kernels.stream_conv.halo import (
    as_pyramid_layers,
    group_geometry,
    working_set_bytes,
)

# One TPU core's VMEM is ~16 MiB; leave the kernel's own headroom to the
# Mosaic allocator and plan against the full size (the cost model is
# deliberately conservative: it sums every slab and operand as if they
# were all live at once).
DEFAULT_VMEM_BUDGET = 16 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class FusionGroup:
    """A contiguous run of conv layers fused into one kernel invocation."""

    layers: tuple  # global conv-layer indices, contiguous
    block_rows: int  # final-output rows per block (0 only for singletons)
    working_set: int  # costed VMEM bytes per block (0 for singletons)

    @property
    def fused(self) -> bool:
        return len(self.layers) > 1


def plan_elem_bytes(quant) -> int:
    """Streamed-slab byte width of a plan's quantization regime: 1 when
    the plan computes in true int8 (frames, inter-layer slabs, tap
    operands and weight codes really are int8 in VMEM), else 4 (the
    fp32/fake-quant paths, where the quantized stream is a rounding
    contract, not a storage format). Accepts any ``QuantSpec``-shaped
    object (or None)."""
    return 1 if getattr(quant, "int8_compute", False) else 4


def group_working_set(
    topo, layer_indices: Sequence[int], *, block_rows: int = 0,
    elem_bytes: int = 4,
) -> int:
    """Costed per-block VMEM bytes of fusing ``layer_indices`` (contiguous
    run) of ``topo`` — the quantity the planner compares to its budget.
    Exposed so tests (and users sizing a budget) can read the model.
    ``elem_bytes`` is the streamed-slab width (see :func:`plan_elem_bytes`);
    accumulators are always charged at 4 bytes (int32/fp32 epilogue)."""
    return working_set_bytes(
        _group_geom(topo, layer_indices, block_rows),
        elem_bytes=elem_bytes, acc_bytes=4,
    )


def group_working_set_breakdown(
    topo, layer_indices: Sequence[int], *, block_rows: int = 0,
    elem_bytes: int = 4,
) -> dict:
    """Per-component bytes behind :func:`group_working_set` (see
    ``halo.working_set_breakdown``) — what the plan verifier cites when
    a group's recorded cost and the model disagree."""
    from repro_torch.kernels.stream_conv.halo import working_set_breakdown

    return working_set_breakdown(
        _group_geom(topo, layer_indices, block_rows),
        elem_bytes=elem_bytes, acc_bytes=4,
    )


def _group_geom(topo, layer_indices: Sequence[int], block_rows: int):
    idxs = tuple(layer_indices)
    h, w = topo.input_shape
    for spec in topo.conv_layers[: idxs[0]]:
        h, w = spec.out_hw(h, w)
    c = (
        topo.input_channels
        if idxs[0] == 0
        else topo.conv_layers[idxs[0] - 1].n_out
    )
    specs = [topo.conv_layers[i] for i in idxs]
    return group_geometry(
        h, w, c,
        as_pyramid_layers(specs),
        tuple(s.kernel for s in specs),
        tuple(s.n_out for s in specs),
        block_rows=block_rows,
    )


def _block_row_candidates(topo, idxs) -> list:
    """The planner's block-size ladder for a group: whole frame first,
    then halved row blocks down to one row."""
    h, w = topo.input_shape
    for spec in topo.conv_layers[: idxs[-1] + 1]:
        h, w = spec.out_hw(h, w)
    candidates = []
    r = h  # final output rows of the group
    while r >= 1:
        candidates.append(r)
        if r == 1:
            break
        r = -(-r // 2)
    return candidates


def _fit_block_rows(
    topo, idxs, budget: int, elem_bytes: int = 4
) -> Optional[tuple]:
    """Largest feasible (block_rows, working_set) for fusing ``idxs``
    under ``budget``: whole-frame first, then halved row blocks down to
    one row. None if nothing fits (or the geometry is unsupported)."""
    for r in _block_row_candidates(topo, idxs):
        try:
            ws = group_working_set(
                topo, idxs, block_rows=r, elem_bytes=elem_bytes
            )
        except ValueError:
            return None  # shape the pyramid cannot lower -> no fusion
        if ws <= budget:
            return r, ws
    return None


def widening_budget(topo, layer_indices: Sequence[int]) -> Optional[dict]:
    """The structural int8-widens-fusion probe: the largest budget at
    which NO fp32-costed block size can fuse the whole run, paired with
    what each costing plans there. Returns ``{"budget", "fp32_max_group",
    "int8_max_group", "n_layers"}`` — int8 widening is demonstrated when
    ``int8_max_group > fp32_max_group`` — or None when even the probe
    budget cannot separate the two costings (e.g. a single-layer run).
    """
    idxs = tuple(layer_indices)
    if len(idxs) < 2:
        return None
    costs = []
    for r in _block_row_candidates(topo, idxs):
        try:
            costs.append(group_working_set(topo, idxs, block_rows=r))
        except ValueError:
            continue
    if not costs:
        return None
    budget = min(costs) - 1  # fp32 cannot fuse the full run at any block
    plans = {
        eb: plan_fusion_groups(
            topo, idxs, vmem_budget=budget, elem_bytes=eb
        )
        for eb in (4, 1)
    }
    return {
        "budget": budget,
        "fp32_max_group": max(len(g.layers) for g in plans[4]),
        "int8_max_group": max(len(g.layers) for g in plans[1]),
        "n_layers": len(idxs),
    }


def plan_fusion_groups(
    topo,
    layer_indices: Sequence[int],
    *,
    vmem_budget: Optional[int] = None,
    elem_bytes: int = 4,
) -> tuple:
    """Partition a contiguous run of conv layers into maximal fusion
    groups under the VMEM budget.

    Greedy left-to-right: each group is extended while the grown group
    still fits (so groups are maximal), and closed when the next layer
    would blow the budget — that layer starts the next group. Layers that
    cannot fuse at all become singleton groups, which lower through the
    single-layer kernel path (bit-identical to the pre-fusion plan).
    ``vmem_budget=None`` means :data:`DEFAULT_VMEM_BUDGET`; ``0`` turns
    fusion off entirely. ``elem_bytes`` is the streamed-slab byte width
    the costing charges (``plan_elem_bytes(quant)`` — 1 for true-int8
    plans, whose slabs really occupy a quarter of the fp32 bytes, so the
    same budget admits strictly wider groups).
    """
    idxs = tuple(layer_indices)
    if not idxs:
        return ()
    if list(idxs) != list(range(idxs[0], idxs[-1] + 1)):
        raise ValueError(f"fusion groups need contiguous layers, got {idxs}")
    budget = DEFAULT_VMEM_BUDGET if vmem_budget is None else vmem_budget
    if budget < 0:
        raise ValueError(f"vmem_budget must be >= 0, got {budget}")

    fit_cache: dict = {}

    def fit_of(i: int, j: int):
        if (i, j) not in fit_cache:
            fit_cache[(i, j)] = _fit_block_rows(
                topo, idxs[i:j], budget, elem_bytes
            )
        return fit_cache[(i, j)]

    def fits(i: int, j: int) -> bool:
        if j - i == 1:
            return True  # singletons lower through the single-layer path
        if budget == 0:
            return False
        return fit_of(i, j) is not None

    groups = []
    for i, j in partition_greedy_budget(len(idxs), fits):
        run = idxs[i:j]
        fit = fit_of(i, j) if j - i > 1 else None
        groups.append(
            FusionGroup(
                layers=run,
                block_rows=fit[0] if fit else 0,
                working_set=fit[1] if fit else 0,
            )
        )
    return tuple(groups)
