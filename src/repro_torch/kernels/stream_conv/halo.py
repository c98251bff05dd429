"""Composed halo algebra for cross-layer fused conv pyramids.

A copy of ``repro.kernels.stream_conv.halo`` (pure Python): the port keeps its own copy so
that it imports nothing of the JAX package. It adds :func:`column_strips`, the column
halo of the single-layer kernel's strips on the card.

A fusion group runs several consecutive conv -> bias -> act -> pool layers
over one block of the *final* output rows, keeping every inter-layer
feature slab in VMEM. The geometry problem is the composition of the
single-layer halo rule (a block of pooled rows needs
``(r-1)*pool_stride + pool`` conv rows, which need ``(r_conv-1)*stride + K``
input rows): walked backwards from the last layer to the first, a block of
``R`` final rows maps to an *affine* interval of every intermediate
feature map —

    rows of layer i's input needed by block ``rb`` =
        [ M_i * rb + O_i,  M_i * rb + O_i + L_i )

with static per-layer multiplier ``M_i``, offset ``O_i`` (negative offsets
mean the block reaches into SAME top padding) and constant slab length
``L_i``. The fused block's input halo is exactly the composition of each
layer's ``max(0, (pool - pool_stride)*s + K - s)`` requirement; overlap
rows are recomputed per block so pool windows never straddle blocks.

This module computes that geometry once, statically, for all three
renderings of a fusion group (the Pallas kernel, the XLA fallback and the
planner's VMEM cost model):

- :func:`group_geometry` builds the per-layer :class:`LayerGeom` chain for
  a given final-rows-per-block ``R``;
- :func:`working_set_bytes` costs the per-block VMEM working set (input
  frame + per-layer slabs + tap operands + weights) that the fusion
  planner compares against its budget.

Row coordinates are *unpadded* feature-map coordinates for every layer:
SAME row padding is part of the interval composition (offsets go
negative), and the kernels realize it by masking slab rows outside
``[0, H_i)`` to zero — which is exactly the SAME zero-padding of that
layer once the slab is consumed by the next conv. Columns are not
blocked: every block spans the full feature width, so column SAME padding
stays a static per-layer pad.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


def same_pads(d: int, stride: int, k: int) -> tuple:
    """XLA's SAME convention for one spatial dim: total = max((ceil(d/s) -
    1)*s + k - d, 0), low = total // 2. Returns (lo, hi)."""
    out = -(-d // stride)
    tot = max((out - 1) * stride + k - d, 0)
    lo = tot // 2
    return lo, tot - lo


def padded_frame(h: int, w: int, k: int, stride: int, padding: str) -> tuple:
    """(H, W) of the frame a layer's VALID conv runs over once its SAME
    pads (``same_pads``) are added: what the single-layer launcher sizes
    its blocks from, and the compiler's check of a plan for the card."""
    if padding == "SAME":
        h += sum(same_pads(h, stride, k))
        w += sum(same_pads(w, stride, k))
    return h, w


@dataclasses.dataclass(frozen=True)
class PyramidLayer:
    """Static per-layer config of a fusion group (the layer vocabulary of
    one conv actor chain, minus the tensor shapes)."""

    padding: str = "VALID"
    stride: int = 1
    act: str = "none"
    pool: int = 0
    pool_stride: int | None = None


def as_pyramid_layers(specs: Sequence) -> tuple:
    """Normalize duck-typed conv-layer specs (e.g. ``ConvLayerSpec``) into
    hashable :class:`PyramidLayer` statics."""
    return tuple(
        PyramidLayer(
            padding=s.padding,
            stride=getattr(s, "stride", 1),
            act=s.act,
            pool=s.pool,
            pool_stride=getattr(s, "pool_stride", None),
        )
        for s in specs
    )


@dataclasses.dataclass(frozen=True)
class LayerGeom:
    """Static geometry of one layer inside a fusion group."""

    # Layer vocabulary (pool window normalized).
    k: int
    stride: int
    act: str
    pw: int  # pool window (0 = none)
    ps: int  # pool stride
    # Frame geometry (unpadded input -> conv -> pooled output).
    in_rows: int
    in_cols: int
    in_ch: int
    pads: tuple  # ((top, bottom), (left, right)) SAME pads
    conv_rows: int
    conv_cols: int
    out_rows: int
    out_cols: int
    n_out: int
    # Per-block affine row intervals (start = mult * rb + off, len rows).
    in_mult: int
    in_off: int
    in_slab_rows: int
    conv_slab_rows: int
    out_slab_rows: int


@dataclasses.dataclass(frozen=True)
class GroupGeometry:
    """The full static geometry of a fusion group for block size R."""

    layers: tuple  # LayerGeom per layer, first to last
    block_rows: int  # R: final output rows per block
    n_row_blocks: int
    out_rows: int  # h_keep of the whole group
    out_cols: int
    # Host-side row padding of the group input frame: the exact SAME pads
    # of layer 0 plus the extra rows that keep every block's (halo'd,
    # possibly negative-offset) read in bounds.
    in_pad_top: int
    in_pad_rows_total: int  # total padded frame rows after host padding
    in_pad_cols: tuple  # (left, right) exact SAME col pads of layer 0

    @property
    def input_row_shift(self) -> int:
        """Shift from unpadded layer-0 row coords to host-padded coords."""
        return self.in_pad_top


def _pool_cfg(layer: PyramidLayer) -> tuple:
    from repro_torch.kernels.stream_conv.epilogue import normalize_pool

    return normalize_pool(layer.pool, layer.pool_stride)


def group_geometry(
    in_rows: int,
    in_cols: int,
    in_ch: int,
    layers: Sequence[PyramidLayer],
    kernels: Sequence[int],
    n_outs: Sequence[int],
    *,
    block_rows: int = 0,
) -> GroupGeometry:
    """Build the composed-halo geometry of a fusion group.

    ``block_rows=0`` means one block covering the whole final output (the
    no-halo fast path). Raises if any layer's spatial dims collapse.
    """
    if not layers:
        raise ValueError("a fusion group needs at least one layer")
    if not len(layers) == len(kernels) == len(n_outs):
        raise ValueError("layers/kernels/n_outs length mismatch")

    # Forward pass: frame dims per layer.
    dims = []  # (H, W, C, pads, conv_r, conv_c, out_r, out_c)
    h, w, c = in_rows, in_cols, in_ch
    for layer, k, n in zip(layers, kernels, n_outs):
        s = layer.stride
        if layer.padding == "SAME":
            pr, pc = same_pads(h, s, k), same_pads(w, s, k)
        elif layer.padding == "VALID":
            pr, pc = (0, 0), (0, 0)
        else:
            raise ValueError(f"unknown padding {layer.padding!r}")
        conv_r = (h + pr[0] + pr[1] - k) // s + 1
        conv_c = (w + pc[0] + pc[1] - k) // s + 1
        if conv_r < 1 or conv_c < 1:
            raise ValueError(
                f"conv output {conv_r}x{conv_c} empty for {h}x{w} input "
                f"(k={k}, stride={s})"
            )
        pw, ps = _pool_cfg(layer)
        if pw:
            if conv_r < pw or conv_c < pw:
                raise ValueError(
                    f"conv output {conv_r}x{conv_c} too small for "
                    f"{pw}x{pw} pool"
                )
            out_r = (conv_r - pw) // ps + 1
            out_c = (conv_c - pw) // ps + 1
        else:
            out_r, out_c = conv_r, conv_c
        dims.append((h, w, c, (pr, pc), conv_r, conv_c, out_r, out_c))
        h, w, c = out_r, out_c, n

    h_keep, w_keep = dims[-1][6], dims[-1][7]
    r = block_rows if block_rows > 0 else h_keep
    r = min(r, h_keep)
    n_rb = -(-h_keep // r)

    # Backward pass: affine input interval per layer, last to first.
    mult, off, length = r, 0, r
    geoms = [None] * len(layers)
    for i in reversed(range(len(layers))):
        layer, k = layers[i], kernels[i]
        h, w, c, pads, conv_r, conv_c, out_r, out_c = dims[i]
        pw, ps = _pool_cfg(layer)
        out_slab = length
        if pw:
            mult, off, length = mult * ps, off * ps, (length - 1) * ps + pw
        conv_slab = length
        s = layer.stride
        tp = pads[0][0]
        mult, off, length = mult * s, off * s - tp, (length - 1) * s + k
        geoms[i] = LayerGeom(
            k=k, stride=s, act=layer.act, pw=pw, ps=ps,
            in_rows=h, in_cols=w, in_ch=c, pads=pads,
            conv_rows=conv_r, conv_cols=conv_c,
            out_rows=out_r, out_cols=out_c, n_out=n_outs[i],
            in_mult=mult, in_off=off, in_slab_rows=length,
            conv_slab_rows=conv_slab, out_slab_rows=out_slab,
        )

    g0 = geoms[0]
    tp0 = g0.pads[0][0]
    # Host row padding: exact SAME top pad plus whatever keeps the most
    # negative block offset in bounds; bottom rows up to the deepest read.
    pad_top = tp0 + max(0, -(g0.in_off + tp0))
    last_end = g0.in_mult * (n_rb - 1) + g0.in_off + pad_top + g0.in_slab_rows
    rows_total = max(last_end, in_rows + pad_top)
    return GroupGeometry(
        layers=tuple(geoms),
        block_rows=r,
        n_row_blocks=n_rb,
        out_rows=h_keep,
        out_cols=w_keep,
        in_pad_top=pad_top,
        in_pad_rows_total=rows_total,
        in_pad_cols=g0.pads[1],
    )


def working_set_bytes(
    geom: GroupGeometry, *, elem_bytes: int = 4, acc_bytes: int | None = None
) -> int:
    """Per-block VMEM working set of the fused pyramid kernel, in bytes.

    Counts the (host-padded) input frame resident per grid cell, and per
    layer: the padded input slab, the column-assembled tap operand, the
    K*K patch operand feeding the single matmul, the conv-output slab, the
    pooled output slab, and the layer's weights + bias. This is the
    quantity the fusion planner holds against its VMEM budget.

    The costing is dtype-parametric: ``elem_bytes`` is the byte width of
    the streamed slabs (frames, inter-layer feature slabs, tap operands,
    weight codes — 4 on the fp32/fake-quant path, 1 when the plan
    computes in true int8 and the slabs really are int8 codes) and
    ``acc_bytes`` the accumulator/epilogue width (the int32 accumulator
    and its fp32 dequantization — defaults to ``elem_bytes`` so the
    historic fp32 totals are unchanged). Bias stays f32 on every path.
    """
    return sum(
        working_set_breakdown(
            geom, elem_bytes=elem_bytes, acc_bytes=acc_bytes
        ).values()
    )


def working_set_breakdown(
    geom: GroupGeometry, *, elem_bytes: int = 4, acc_bytes: int | None = None
) -> dict:
    """Per-component bytes of :func:`working_set_bytes` — ``frame`` for
    the resident input frame plus, per layer i, ``L{i}/slab_in``, ``z``,
    ``patches``, ``conv``, ``out`` and ``weights``. The plan verifier's
    resource findings (V201/V202/V204) cite this so a budget blow-up
    names the component that grew, not just the total.

    Streamed components (frame, input slabs, tap assembly, patches,
    inter-layer outputs, weight codes) are charged at ``elem_bytes``; the
    conv accumulator slabs and the group's final fp32 output at
    ``acc_bytes`` (default: ``elem_bytes``); bias at 4 bytes (f32 on
    every path)."""
    acc = elem_bytes if acc_bytes is None else acc_bytes
    g0 = geom.layers[0]
    last = len(geom.layers) - 1
    cols0 = g0.in_cols + sum(geom.in_pad_cols)
    parts = {
        "frame": geom.in_pad_rows_total * cols0 * g0.in_ch * elem_bytes
    }
    for i, g in enumerate(geom.layers):
        padded_cols = g.in_cols + g.pads[1][0] + g.pads[1][1]
        parts[f"L{i}/slab_in"] = (
            g.in_slab_rows * padded_cols * g.in_ch * elem_bytes
        )
        parts[f"L{i}/z"] = (
            g.in_slab_rows * g.conv_cols * g.k * g.in_ch * elem_bytes
        )
        parts[f"L{i}/patches"] = (
            g.conv_slab_rows * g.conv_cols * g.k * g.k * g.in_ch * elem_bytes
        )
        parts[f"L{i}/conv"] = g.conv_slab_rows * g.conv_cols * g.n_out * acc
        out_bytes = acc if i == last else elem_bytes
        parts[f"L{i}/out"] = g.out_slab_rows * g.out_cols * g.n_out * out_bytes
        parts[f"L{i}/weights"] = (
            g.k * g.k * g.in_ch * g.n_out * elem_bytes + g.n_out * 4
        )
    return parts


def column_strips(in_cols: int, k: int, stride: int, pw: int, ps: int,
                  strip_cols: int) -> tuple:
    """Column strips of one VALID conv (kernel ``k``, ``stride``) and max
    pool (window ``pw``, stride ``ps``; ``pw=0`` for none) over a frame of
    ``in_cols`` (already padded) columns, ``strip_cols`` pooled output
    columns each (the last may be narrower). Per strip ``(in_lo, in_hi,
    out_lo, out_hi)``: its output columns ``[out_lo, out_hi)`` read exactly
    the input columns ``[in_lo, in_hi)`` -- the pool windows' conv columns
    ``[out_lo*ps, (out_hi-1)*ps + pw)`` widened by the conv's halo. The
    row rule of the single-layer kernel, applied to columns: strips
    overlap by the halo, and each output column is computed once."""
    if strip_cols < 1:
        raise ValueError(f"strip_cols must be >= 1, got {strip_cols}")
    conv_cols = (in_cols - k) // stride + 1
    out_cols = (conv_cols - pw) // ps + 1 if pw else conv_cols
    strips = []
    for lo in range(0, out_cols, strip_cols):
        hi = min(out_cols, lo + strip_cols)
        c_lo, c_hi = (lo * ps, (hi - 1) * ps + pw) if pw else (lo, hi)
        strips.append((c_lo * stride, (c_hi - 1) * stride + k, lo, hi))
    return tuple(strips)
