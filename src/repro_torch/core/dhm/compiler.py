"""Graph-driven DHM compiler: CNNTopology -> DPN -> stages -> execution plan.

The counterpart of ``repro.core.dhm.compiler``. ``compile_dhm`` is the one
lowering path:

1. **Validate** the topology (act / pool / padding / stride vocabulary,
   positive spatial dims).
2. **Expand** it into the paper-granularity dataflow process network
   (``cnn_to_dpn``).
3. **Partition** the actor graph into ``n_stages`` contiguous stages with
   the exact min-max DP mapper, costed from the actor FLOP payloads.
4. **Fuse** each stage's layers into maximal fusion groups under the
   reference's budget (``fusion.py``): a multi-layer group runs as ONE
   launch of the pyramid kernel, a singleton through the single-layer
   kernel. A plan for the card then splits the groups the pyramid kernel
   cannot take (``card_fusion_groups``) and checks that the single-layer
   kernel serves every singleton, so that no launch of an accepted plan is
   refused; a CPU plan keeps the reference's groups exactly.
5. **Emit** per-stage closures with the quantization baked in: weights
   fake-quantized, pow2-projected or baked to int8 codes once at compile
   time, the feature stream quantized in the kernels' epilogue
   (``act_bits``). Under ``int8_compute`` the conv kernels run their int8
   variants; under ``pow2_weights`` (with no ``weight_bits``) the FC head
   runs through the packed ``pow2_matmul`` kernel, in integers when the
   plan is also ``int8_compute``.

The plan lives on one device: the card unless ``device="cpu"``, where the
kernel wrappers run their plain versions.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Sequence

import torch

from repro_torch.core.dhm.fusion import (
    DEFAULT_VMEM_BUDGET,
    FusionGroup,
    _group_geom,
    group_working_set,
    plan_elem_bytes,
    plan_fusion_groups,
)
from repro_torch.core.dhm.graph import DataflowGraph, cnn_to_dpn
from repro_torch.core.dhm.mapping import StageAssignment, partition_stages
from repro_torch.core.dhm.pipeline import StageIOSpec
from repro_torch.core.quant.fixed_point import (
    dynamic_spec,
    fake_quant_dynamic,
    fake_quant_ste,
    quantize_fixed,
)
from repro_torch.core.quant.pow2 import project_pow2, project_pow2_ste
from repro_torch.kernels import probe
from repro_torch.kernels.backends import resolve_device
from repro_torch.kernels.pow2_matmul import pow2_matmul, quantize_weights
from repro_torch.kernels.stream_conv.conv import (
    card_groups,
    fused_plan,
    int8_pyramid_layout,
    kmajor_weights,
    pyramid_layout,
)
from repro_torch.kernels.stream_conv.epilogue import (
    ACTS,
    Int8Scales,
    normalize_pool,
    stream_quant_spec,
)
from repro_torch.kernels.stream_conv.halo import as_pyramid_layers, padded_frame

PADDINGS = ("SAME", "VALID")


class PlanCheckError(ValueError):
    """A compiled plan failed its self-check (non-finite baked parameters
    or inconsistent stage / head geometry) — the plan is not fit to serve.
    ``invariants`` names the registry's IDs of the failed checks."""

    def __init__(self, message: str, *, invariants=()):
        super().__init__(message)
        self.invariants = tuple(invariants)


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """The quantization contract baked into a compiled plan.

    ``weight_bits``: fixed-point fake-quant of all parameters (dynamic
    power-of-two scales, STE gradients). ``act_bits``: fixed-point width of
    the inter-actor feature stream, applied inside the kernel epilogue.
    ``per_layer_bits``: per-conv-layer widths overriding both for that
    layer. ``pow2_weights``: project weights onto the {0, ±2^k} codebook;
    the FC head then runs through the packed ``pow2_matmul`` kernel (when
    no ``weight_bits`` is stacked on top). ``int8_compute``: run the conv
    layers in true integer arithmetic (int8 weight codes with a static
    pow2 scale, int8 stream codes, int32 accumulation); requires a weight
    AND act width (<= 8) for every conv layer. Int8 plans are
    forward-only.
    """

    weight_bits: Optional[int] = None
    act_bits: Optional[int] = None
    pow2_weights: bool = False
    int8_compute: bool = False
    per_layer_bits: Optional[tuple] = None

    def __post_init__(self):
        for name in ("weight_bits", "act_bits"):
            v = getattr(self, name)
            if v is not None and v < 2:
                raise ValueError(f"{name} must be >= 2 (or None), got {v}")
        if self.per_layer_bits is not None:
            object.__setattr__(
                self, "per_layer_bits", tuple(self.per_layer_bits)
            )
            for b in self.per_layer_bits:
                if not isinstance(b, int) or isinstance(b, bool) or b < 2:
                    raise ValueError(
                        f"per_layer_bits entries must be ints >= 2, got "
                        f"{self.per_layer_bits}"
                    )
        if self.int8_compute:
            n = (
                len(self.per_layer_bits)
                if self.per_layer_bits is not None
                else 1
            )
            for i in range(n):
                wb, ab = self.conv_weight_bits(i), self.conv_act_bits(i)
                if wb is None or ab is None:
                    raise ValueError(
                        "int8_compute requires a weight AND act bit width "
                        "for every conv layer (weight_bits/act_bits or "
                        "per_layer_bits)"
                    )
                if wb > 8 or ab > 8:
                    raise ValueError(
                        f"int8_compute requires all conv bit widths <= 8, "
                        f"got weight={wb} act={ab} for layer {i}"
                    )

    def conv_weight_bits(self, i: int) -> Optional[int]:
        """Weight bit width of conv layer ``i`` (per-layer override wins)."""
        if self.per_layer_bits is not None:
            return self.per_layer_bits[i]
        return self.weight_bits

    def conv_act_bits(self, i: int) -> Optional[int]:
        """Feature-stream bit width AFTER conv layer ``i`` (per-layer
        override wins)."""
        if self.per_layer_bits is not None:
            return self.per_layer_bits[i]
        return self.act_bits

    @property
    def mixed_bitwidth(self) -> bool:
        return self.per_layer_bits is not None

    @property
    def stream_bits(self) -> int:
        """Fixed-point width used to size DPN line buffers and streams."""
        if self.per_layer_bits is not None:
            return max(self.per_layer_bits)
        return self.act_bits or self.weight_bits or 32

    @property
    def packed_fc_head(self) -> bool:
        """Whether the FC head lowers through the packed pow2 kernel."""
        return self.pow2_weights and self.weight_bits is None


def _spec_fields(spec) -> dict:
    return dict(
        padding=spec.padding,
        act=spec.act,
        pool=spec.pool,
        pool_stride=getattr(spec, "pool_stride", None),
        stride=getattr(spec, "stride", 1),
    )


def _validate_layer(
    where: str, *, padding: str, act: str, pool: int,
    pool_stride: int | None = None, stride: int = 1,
) -> None:
    if act not in ACTS:
        raise ValueError(f"{where}: unknown act {act!r}; expected one of {ACTS}")
    try:
        normalize_pool(pool, pool_stride)
    except ValueError as e:
        raise ValueError(f"{where}: {e}") from None
    if not isinstance(stride, int) or isinstance(stride, bool) or stride < 1:
        raise ValueError(
            f"{where}: conv stride must be a positive int, got {stride!r}"
        )
    if padding not in PADDINGS:
        raise ValueError(
            f"{where}: unknown padding {padding!r}; expected one of {PADDINGS}"
        )


def validate_topology(topo) -> None:
    """Validate every conv layer of a CNNTopology at compile time: the
    layer vocabulary, the head's activation, and that every layer keeps
    positive spatial dims."""
    for li, spec in enumerate(topo.conv_layers):
        _validate_layer(f"{topo.name} conv layer {li}", **_spec_fields(spec))
    if topo.fc_act not in ACTS:
        raise ValueError(
            f"{topo.name} head: unknown fc_act {topo.fc_act!r}; expected one of {ACTS}"
        )
    h, w = topo.input_shape
    for li, spec in enumerate(topo.conv_layers):
        where = f"{topo.name} conv layer {li}"
        h_c, w_c = spec.conv_hw(h, w)
        if h_c < 1 or w_c < 1:
            raise ValueError(
                f"{where}: conv output {h_c}x{w_c} is empty for a {h}x{w} "
                f"input (kernel={spec.kernel}, stride={spec.stride}, "
                f"padding={spec.padding})"
            )
        pw, _ = spec.pool_cfg
        if pw and (h_c < pw or w_c < pw):
            raise ValueError(
                f"{where}: conv output {h_c}x{w_c} too small for a "
                f"{pw}x{pw} pool window"
            )
        h, w = spec.out_hw(h, w)


@functools.lru_cache(maxsize=64)
def _cached_dpn(topo, bits: int) -> DataflowGraph:
    """The actor-graph expansion, built once per (topology, bit-width)."""
    return cnn_to_dpn(topo, bits=bits)


def _conv_layer_costs(graph: DataflowGraph, n_conv: int) -> list:
    """Per-conv-layer FLOP cost summed from the actor payloads (conv layer
    i owns DPN topological layer i + 1; layer 0 is the source)."""
    by_layer: dict = {}
    for a in graph.actors:
        by_layer[a.layer] = by_layer.get(a.layer, 0.0) + a.flops
    return [by_layer.get(i + 1, 0.0) for i in range(n_conv)]


@functools.lru_cache(maxsize=256)
def _cached_layout(topo, bits: int, n_stages: int) -> StageAssignment:
    graph = _cached_dpn(topo, bits)
    costs = _conv_layer_costs(graph, len(topo.conv_layers))
    return partition_stages(costs, n_stages)


def _conv_dims(topo, last: int) -> list:
    """(H, W, C) entering each conv layer of ``topo`` up to ``last``."""
    dims = [(*topo.input_shape, topo.input_channels)]
    for spec in topo.conv_layers[:last]:
        dims.append((*spec.out_hw(*dims[-1][:2]), spec.n_out))
    return dims


def _singleton_plan(topo, layer: int, *, elem_bytes: int, block_r: int) -> dict:
    """The single-layer launcher's ``conv.fused_plan`` for conv layer
    ``layer`` alone, over the frame ``halo.padded_frame`` gives it."""
    sp = topo.conv_layers[layer]
    h, w, c = _conv_dims(topo, layer)[layer]
    return fused_plan(*padded_frame(h, w, sp.kernel, sp.stride, sp.padding), c,
                      k=sp.kernel, stride=sp.stride, pool=sp.pool,
                      pool_stride=sp.pool_stride, block_r=block_r, n_out=sp.n_out,
                      elem_bytes=elem_bytes)


@dataclasses.dataclass(frozen=True)
class CardLaunch:
    """The launches of one card fusion group: the kernel wrapper that runs
    it (the ``conv.LAUNCHES`` key), its conv-layer indices, and its column
    strips and output-channel slices (1 and 1 for a pyramid group), one
    launch each pair; and the main loop its launches take
    (``conv.fused_path`` for an int8 singleton): "wgmma" or "mma_sync"
    (int8), "fma" (fp32)."""

    kernel: str
    layers: tuple
    strips: int = 1
    slices: int = 1
    path: str = "mma_sync"

    @property
    def launches(self) -> int:
        return self.strips * self.slices


def card_launch(topo, group, *, elem_bytes: int = 4, block_r: int = 8) -> CardLaunch:
    """The :class:`CardLaunch` of one card fusion group: one pyramid launch
    for a multi-layer group, the single-layer launcher's strips times its
    slices and its path (``conv.fused_plan``) for a singleton."""
    suffix = "_int8" if elem_bytes == 1 else ""
    layers = tuple(group.layers)
    if len(layers) > 1:
        return CardLaunch(kernel="stream_conv_pyramid" + suffix, layers=layers,
                          path="mma_sync" if elem_bytes == 1 else "fma")
    geo = _singleton_plan(topo, layers[0], elem_bytes=elem_bytes, block_r=block_r)
    return CardLaunch(kernel="stream_conv_fused" + suffix, layers=layers,
                      strips=len(geo["strips"]), slices=len(geo["slices"]), path=geo["path"])


@functools.lru_cache(maxsize=1024)
def card_group_cost(topo, layers: tuple, block_rows: int, *, elem_bytes: int = 4,
                    block_r: int = 8) -> tuple:
    """What one fusion group costs on the card, as ``conv.py`` sizes it
    today: ``(launches, shared-memory bytes per block, parts)``. A
    multi-layer group is one launch of the pyramid kernel, whose block
    holds ``conv.pyramid_smem_bytes`` (``pyramid_layout`` at 4 B/elt,
    ``int8_pyramid_layout`` at 1) for the group's geometry at
    ``block_rows``; a singleton is the single-layer launcher's
    ``conv.fused_plan`` over the frame ``halo.padded_frame`` gives it, one
    launch per column strip and channel slice, each requesting the same
    bytes. ``parts`` splits the bytes into the slab buffers, the tap table
    and the weight stages. Raises ``ValueError`` where the single-layer
    launcher cannot serve the layer."""
    layers = tuple(layers)
    unit = 1 if elem_bytes == 1 else 4  # the layouts' offsets: bytes or 4-byte words
    if len(layers) > 1:
        geom = _group_geom(topo, layers, block_rows)
        lay = int8_pyramid_layout(geom) if elem_bytes == 1 else pyramid_layout(geom)
        n, smem, tap_off, wst_off = 1, lay.smem, lay.tap_off, lay.wst_off
    else:
        geo = _singleton_plan(topo, layers[0], elem_bytes=elem_bytes, block_r=block_r)
        n = len(geo["strips"]) * len(geo["slices"])
        smem, tap_off, wst_off = geo["smem"], geo["tap_off"], geo["wst_off"]
    parts = {"slab buffers": unit * tap_off, "tap table": unit * (wst_off - tap_off),
             "weight stages": smem - unit * wst_off}
    return n, smem, parts


@functools.lru_cache(maxsize=256)
def card_fusion_groups(topo, layer_indices: Sequence[int], groups: Sequence, *,
                       elem_bytes: int = 4, block_r: int = 8) -> tuple:
    """The fusion groups a plan for the card runs: the reference's
    ``groups`` of a contiguous run of conv layers, split where the pyramid
    kernel cannot take them (``conv.card_groups``: at most
    ``MAX_PYRAMID_LAYERS`` layers within ``SMEM_LIMIT``). Every singleton
    is sized by the single-layer launcher's own ``fused_plan`` (row
    blocks, column strips, channel slices) here, at compile time, over
    the frame ``halo.padded_frame`` gives the launcher: a layer it cannot
    serve raises now, not at the plan's first call."""
    idxs = tuple(layer_indices)
    dims = _conv_dims(topo, idxs[-1])[idxs[0]:]
    specs = [topo.conv_layers[i] for i in idxs]
    local = card_groups(
        *dims[0], as_pyramid_layers(specs), tuple(sp.kernel for sp in specs),
        tuple(sp.n_out for sp in specs),
        tuple((tuple(li - idxs[0] for li in g.layers), g.block_rows) for g in groups),
        elem_bytes=elem_bytes,
    )
    out = []
    for g, block_rows in local:
        layers = tuple(idxs[0] + li for li in g)
        try:
            card_group_cost(topo, layers, block_rows, elem_bytes=elem_bytes, block_r=block_r)
        except ValueError as e:
            raise ValueError(f"{topo.name} conv layer {layers[0]} cannot run on the card: {e}") from e
        ws = group_working_set(topo, layers, block_rows=block_rows,
                               elem_bytes=elem_bytes) if len(g) > 1 else 0
        out.append(FusionGroup(layers=layers, block_rows=block_rows, working_set=ws))
    return tuple(out)


def emit_conv_stage(
    specs: Sequence,
    *,
    act_bits=None,  # int | None | per-layer tuple
    int8_scales: Optional[Sequence] = None,  # per-layer Int8Scales | None
    block_r: int = 8,
    groups: Optional[Sequence] = None,
) -> Callable:
    """Emit one pipeline-stage body: a chain of fused conv actor chains.

    ``groups`` partitions the stage's layers into fusion groups — a
    sequence of ``(local_layer_indices, block_rows)`` pairs covering the
    stage contiguously. A multi-layer group lowers through ONE
    ``stream_conv_pyramid`` launch; a singleton through one
    ``stream_conv_block`` launch (``block_r`` conv rows per CUDA block).
    ``groups=None`` means all-singleton — the per-layer stage body.
    ``int8_scales`` (one ``Int8Scales`` per stage layer) switches the
    kernels to their int8 variants; ``params`` then hold int8 weight
    codes.

    The returned ``stage_fn(params, x)`` runs the stage on the device of
    ``x``; ``params`` is a list with one ``{"w", "b"}`` dict per layer (a
    bare dict is accepted for single-layer stages), which may also hold
    ``"wk"``, the int8 codes as the single-layer kernel's wgmma path reads
    them (``conv.kmajor_weights``).
    """
    from repro_torch.kernels.stream_conv import (
        stream_conv_block,
        stream_conv_pyramid,
    )

    specs = tuple(specs)
    if not specs:
        raise ValueError("a conv stage needs at least one layer spec")
    bits = (
        tuple(act_bits)
        if isinstance(act_bits, (tuple, list))
        else (act_bits,) * len(specs)
    )
    if len(bits) != len(specs):
        raise ValueError(
            f"act_bits tuple has {len(bits)} entries for a "
            f"{len(specs)}-layer stage"
        )
    scales = None if int8_scales is None else tuple(int8_scales)
    if scales is not None and len(scales) != len(specs):
        raise ValueError(
            f"int8_scales has {len(scales)} entries for a "
            f"{len(specs)}-layer stage"
        )
    layer_kw = []
    for li, spec in enumerate(specs):
        fields = _spec_fields(spec)
        _validate_layer(f"stage layer {li}", **fields)
        layer_kw.append(fields)
    if groups is None:
        group_plan = tuple(((li,), 0) for li in range(len(specs)))
    else:
        group_plan = tuple((tuple(g), int(br)) for g, br in groups)
        covered = [li for g, _ in group_plan for li in g]
        if covered != list(range(len(specs))):
            raise ValueError(
                f"fusion groups {group_plan} do not cover stage layers "
                f"0..{len(specs) - 1} contiguously"
            )

    def stage_fn(params, x):
        layer_params = [params] if isinstance(params, dict) else list(params)
        if len(layer_params) != len(specs):
            raise ValueError(
                f"stage has {len(specs)} layers but got "
                f"{len(layer_params)} param dicts"
            )
        for g, block_rows in group_plan:
            if len(g) == 1:
                p = layer_params[g[0]]
                x = stream_conv_block(
                    x, p["w"], p["b"], act_bits=bits[g[0]],
                    int8_scales=None if scales is None else scales[g[0]],
                    block_r=block_r, w_kmajor=p.get("wk"), **layer_kw[g[0]],
                )
            else:
                x = stream_conv_pyramid(
                    x,
                    [layer_params[li]["w"] for li in g],
                    [layer_params[li]["b"] for li in g],
                    layers=[specs[li] for li in g],
                    act_bits=tuple(bits[li] for li in g),
                    int8_scales=(
                        None if scales is None else tuple(scales[li] for li in g)
                    ),
                    block_rows=block_rows,
                )
        return x

    return stage_fn


# ---------------------------------------------------------------------------
# Quantization baking


def _bake_conv_params(conv_params, quant: QuantSpec, device) -> tuple:
    """Bake every conv tensor once, at compile time, onto ``device``, in
    the reference's order: pow2 projection first, then fixed-point
    fake-quant (dynamic pow2 scales).

    Returns ``(baked_params, w_scales)``. Under ``quant.int8_compute`` the
    weights bake to int8 CODES on the grid ``fake_quant_dynamic`` would
    use (``codes * scale == fake_quant_dynamic(w, bits)`` exactly) and
    ``w_scales`` carries each layer's static pow2 scale (read on the
    host: the int8 plan is forward-only); otherwise ``w_scales`` is None
    and the bake reads no value on the host, so a training step that
    compiles its plan can be captured in a CUDA graph
    (``paper/train_cnn.py`` ``JittedTrainStep``)."""
    out, w_scales = [], []
    for i, p in enumerate(conv_params):
        w = p["w"].to(device, torch.float32).contiguous()
        b = p["b"].to(device, torch.float32).contiguous()
        wb = quant.conv_weight_bits(i)
        if quant.pow2_weights:
            w = project_pow2_ste(w)
        if quant.int8_compute:
            wspec = dynamic_spec(w, wb)
            w = quantize_fixed(w, wspec).to(torch.int8)
            b = fake_quant_dynamic(b, wb)
            w_scales.append(float(wspec.scale))
        elif wb is not None:
            w = fake_quant_dynamic(w, wb)
            b = fake_quant_dynamic(b, wb)
        out.append({"w": w.contiguous(), "b": b.contiguous()})
    return tuple(out), (tuple(w_scales) if quant.int8_compute else None)


def _kmajor_params(conv_params, launches) -> tuple:
    """A card int8 plan's codes with, for each singleton its launch table
    sends down the single-layer kernel's wgmma path (``CardLaunch.path``),
    the codes laid out once as that path streams them
    (``conv.kmajor_weights``) under ``"wk"``, beside ``"w"``. Any other
    call of the kernel on that path (eager, or the Engine's single-layer
    rung for a layer the plan fuses) lays them out at the call."""
    out = list(conv_params)
    for ln in launches:
        if ln.path == "wgmma":
            (i,) = ln.layers
            out[i] = {**out[i], "wk": kmajor_weights(out[i]["w"])}
    return tuple(out)


class _Pow2LinearSTE(torch.autograd.Function):
    """Forward through the packed pow2 kernel; backward straight-through,
    as if the layer were ``x @ project_pow2(w)``."""

    @staticmethod
    def forward(ctx, x, w, packed, scale, x_spec):
        ctx.save_for_backward(x, w)
        return pow2_matmul(x, packed, scale, x_spec=x_spec)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        w_proj = project_pow2(w, channel_axis=1)
        return (
            torch.matmul(g, w_proj.T.to(g.dtype)),
            torch.matmul(x.T.to(g.dtype), g),  # STE: identity through the projection
            None, None, None,
        )


def _pow2_linear_ste(x, w, x_spec=None, *, packed=None, scale=None):
    """``x @ decode(pack(w))`` through the packed pow2 kernel, with
    straight-through gradients (so pow2 QAT keeps training). A static
    ``x_spec`` (the activation's fixed-point grid) forwards through the
    true-integer rendering. ``packed``/``scale`` are ``quantize_weights(w)``
    when the caller baked them already (the compiled head does, once)."""
    if packed is None:
        packed, scale = quantize_weights(w)
    return _Pow2LinearSTE.apply(x, w, packed, scale, x_spec)


def _emit_head(fc_params, quant: QuantSpec, device, head_in_bits=None,
               fc_act: str = "tanh") -> tuple:
    """Emit the classifier head: flatten -> FC stack (``fc_act`` +
    feature-stream quant between hidden layers; logits unquantized, as in
    the reference).
    Dense products are ``torch.matmul`` in float32; PyTorch's default keeps
    TF32 off for them (``torch.backends.cuda.matmul.allow_tf32``).

    With the packed pow2 head each FC runs through ``pow2_matmul`` on codes
    packed once here. Under ``int8_compute`` (with ``act_bits``) it runs in
    integers: the first FC's input grid is the LAST conv layer's stream
    spec (``head_in_bits``), later FCs see the head's own ``act_bits``
    stream quant. Returns ``(head_fn, baked_params)``."""
    baked = []
    for p in fc_params:
        w = p["w"].to(device, torch.float32)
        b = p["b"].to(device, torch.float32)
        if quant.pow2_weights and not quant.packed_fc_head:
            w = project_pow2_ste(w)
        if quant.weight_bits is not None:
            w = fake_quant_dynamic(w, quant.weight_bits)
            b = fake_quant_dynamic(b, quant.weight_bits)
        entry = {"w": w, "b": b}
        if quant.packed_fc_head:
            entry["packed"], entry["scale"] = quantize_weights(w)
        baked.append(entry)
    qact_spec = (
        stream_quant_spec(quant.act_bits) if quant.act_bits is not None else None
    )
    int_head = (
        quant.int8_compute and quant.packed_fc_head and quant.act_bits is not None
    )
    # The activation grid each FC's input lives on: the conv stream for the
    # first FC, the head's own stream quant after that.
    first_spec = (
        stream_quant_spec(
            head_in_bits if head_in_bits is not None else quant.act_bits
        )
        if int_head
        else None
    )

    act = {"tanh": torch.tanh, "relu": torch.relu, "none": lambda t: t}[fc_act]

    def head_fn(h):
        h = h.reshape(h.shape[0], -1)
        for i, p in enumerate(baked):
            if quant.packed_fc_head:
                x_spec = (first_spec if i == 0 else qact_spec) if int_head else None
                h = _pow2_linear_ste(
                    h, p["w"], x_spec, packed=p["packed"], scale=p["scale"]
                ) + p["b"]
            else:
                h = torch.matmul(h, p["w"]) + p["b"]
            if i < len(baked) - 1:
                h = act(h)
                if qact_spec is not None:
                    h = fake_quant_ste(h, qact_spec)
        return h

    return head_fn, tuple(baked)


# ---------------------------------------------------------------------------
# The compiled plan


@dataclasses.dataclass(frozen=True)
class CompiledStage:
    """One pipeline stage: a contiguous run of conv layers lowered as a
    chain of fusion groups (each group one kernel launch)."""

    index: int
    conv_layers: tuple  # conv-layer indices owned by this stage
    specs: tuple  # the ConvLayerSpec per owned layer
    fn: Callable  # (params_list, x) -> y
    cost_flops: float  # summed actor payloads (the mapper's stage cost)
    groups: tuple = ()  # FusionGroup per kernel launch in this stage
    io: Optional[StageIOSpec] = None  # (H, W, C) activation edge geometry
    # A card plan's shared memory per block of each group's launches, in
    # group order (``card_group_cost``, which the verifier's resource scope
    # holds against SMEM_LIMIT); () on a CPU plan.
    card_smem: tuple = ()
    # A card plan's CardLaunch per group, in group order; () on a CPU plan.
    launches: tuple = ()


@dataclasses.dataclass(frozen=True)
class CompiledDHM:
    """Executable lowering of a CNN topology on one device: quantized
    parameters + per-stage kernel closures + the FC head, plus the IR
    artifacts (DPN graph, stage assignment) the lowering went through."""

    topo: object
    quant: QuantSpec
    device: torch.device
    graph: DataflowGraph
    assignment: StageAssignment
    stages: tuple
    conv_params: tuple  # per conv layer {"w", "b"}, quantization baked
    head_fn: Callable
    fc_params: tuple = ()  # per FC layer {"w", "b"[, "packed", "scale"]}, baked
    vmem_budget: int = DEFAULT_VMEM_BUDGET
    block_r: int = 8
    int8_scales: tuple = ()  # per conv layer Int8Scales when int8_compute

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    def stage_quant_kwargs(self, stage: int) -> dict:
        """The quantization kwargs ``emit_conv_stage`` needs to re-emit
        stage ``stage``'s body (the Engine's per-layer rung must inherit the
        plan's int8 / mixed-bitwidth contract, not just ``act_bits``)."""
        st = self.stages[stage]
        if not self.int8_scales and not self.quant.mixed_bitwidth:
            return {"act_bits": self.quant.act_bits}
        kw = {
            "act_bits": tuple(self.quant.conv_act_bits(i) for i in st.conv_layers)
        }
        if self.int8_scales:
            kw["int8_scales"] = tuple(self.int8_scales[i] for i in st.conv_layers)
        return kw

    @property
    def fusion_groups(self) -> tuple:
        """Every FusionGroup of the plan, in execution order."""
        return tuple(g for st in self.stages for g in st.groups)

    @property
    def card_smem(self) -> tuple:
        """The shared memory each fusion group's launches request on the
        card, in execution order (() on a CPU plan)."""
        return tuple(b for st in self.stages for b in st.card_smem)

    @property
    def launch_table(self) -> tuple:
        """The conv launches of one forward on the card: a
        :class:`CardLaunch` per fusion group, in execution order (() on a
        CPU plan). Their ``launches`` sum to the stream-conv launches of
        one call (and of one replay of the plan's graph, whose capture
        record keeps this table)."""
        return tuple(g for st in self.stages for g in st.launches)

    def stage_params(self, stage: int) -> list:
        return [self.conv_params[i] for i in self.stages[stage].conv_layers]

    def self_check(self) -> None:
        """Health-probe the plan (see :func:`check_plan`)."""
        check_plan(self)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """Run the conv stages sequentially on the plan's device, each
        under the span ``repro_torch.dhm.stage``."""
        for st in self.stages:
            with probe.span("repro_torch.dhm.stage"):
                x = st.fn(self.stage_params(st.index), x)
        return x

    def jitted_forward(self, *, donate: bool = False) -> Callable:
        """The plan's cached end-to-end closure (see
        ``repro_torch.core.dhm.engine.plan_jitted_forward``, where
        execution lives): on the card, one CUDA graph per input shape.
        ``donate=True`` gives the variant the serving ``Engine`` stages
        its batches into."""
        from repro_torch.core.dhm.engine import plan_jitted_forward

        return plan_jitted_forward(self, donate=donate)

    def __call__(self, x) -> torch.Tensor:
        """x: (B, H, W, C) NHWC frames (a tensor or anything
        ``torch.as_tensor`` takes) -> logits (B, n_classes) on the plan's
        device. Runs the cached closure (``jitted_forward``); the eager
        composition is ``engine.forward``."""
        return self.jitted_forward()(
            torch.as_tensor(x, dtype=torch.float32, device=self.device))

    # -- spatial (mesh) execution ------------------------------------------

    def pipeline_spec(self):
        """Per-stage closures + params + per-edge activation geometry
        (:class:`StageIOSpec`) for the heterogeneous streaming executor."""
        from repro_torch.core.dhm.engine import pipeline_spec

        return pipeline_spec(self)

    def edge_plan(self, *, mode: str = "auto", max_classes: int = 4):
        """How this plan's interior stage-boundary activations travel
        between slots: the :class:`~repro_torch.core.dhm.pipeline.EdgePlan`
        (shape classes, per-class pairs, padding fraction) the executor
        builds from the :class:`StageIOSpec` chain."""
        from repro_torch.core.dhm.pipeline import plan_edges

        return plan_edges(
            [st.io for st in self.stages], mode=mode, max_classes=max_classes
        )

    def edge_shapes(self) -> tuple:
        """The exact per-interior-edge activation element shapes (stage
        s -> s+1), straight off the :class:`StageIOSpec` chain."""
        return tuple(
            tuple(self.stages[s].io.out_shape)
            for s in range(self.n_stages - 1)
        )

    def run_pipelined(
        self, microbatches, *, mesh, cfg=None, data_axis=None,
        overlap=False, edge_mode="auto",
    ):
        """Stream (M, mb, H, W, C) µbatches through the conv stages on a
        mesh (one slot per stage; with ``data_axis`` each data column of a
        2D ``(stage, data)`` mesh takes its shard of the µbatch;
        ``overlap``/``edge_mode`` select the copy-stream schedule and the
        edge path). Returns the feature stream; apply ``head_fn`` after
        re-flattening for logits."""
        from repro_torch.core.dhm.engine import run_pipelined

        return run_pipelined(
            self, microbatches, mesh=mesh, cfg=cfg, data_axis=data_axis,
            overlap=overlap, edge_mode=edge_mode,
        )


def check_plan(plan: CompiledDHM) -> None:
    """Self-check a compiled plan: the ``plan``-scope invariants of the
    ``repro_torch.analysis`` registry — every baked parameter finite
    (V301), the per-stage IO geometry chains (V302), every emitted stage
    body and the head produce the shapes their :class:`StageIOSpec` and
    the topology promise (V303/V304, each run on one zero frame on the
    plan's device), the serving surface is present (V305).

    Raises :class:`PlanCheckError` carrying the failed invariant IDs.
    This doubles as the serving engine's health probe: a rung of the
    degradation ladder is only promoted into service after the plan it
    runs passes this check, so serving and the tests enforce the SAME
    registry.
    """
    from repro_torch.analysis.verify import check_plan as _registry_check

    _registry_check(plan)


def compile_dhm(
    topo,
    params: dict,
    *,
    quant: QuantSpec = QuantSpec(),
    n_stages: int = 1,
    device=None,
    block_r: int = 8,
    vmem_budget: Optional[int] = None,
) -> CompiledDHM:
    """Lower a CNNTopology + params to an executable DHM plan.

    Args:
      topo: a ``repro_torch.models.cnn.CNNTopology``.
      params: ``{"conv": [{"w", "b"}...], "fc": [{"w", "b"}...]}`` tensors
        (``init_cnn``, or the reference's through
        ``convert.params_from_numpy``). Quantization per ``quant`` is baked
        into the plan here, once.
      quant: the :class:`QuantSpec` contract.
      n_stages: contiguous stages to partition the conv stack into.
      device: where the plan runs — the card unless ``"cpu"``.
      block_r: conv rows per CUDA block of the single-layer kernel.
      vmem_budget: the reference fusion planner's per-block budget in bytes
        (None = its default, under which every topology's feature extractor
        fuses into one group; 0 = per-layer plan).
    """
    dev = resolve_device(device)
    validate_topology(topo)
    n_conv = len(topo.conv_layers)
    if not 1 <= n_stages <= n_conv:
        raise ValueError(
            f"n_stages must be in [1, {n_conv}] for {topo.name}, got {n_stages}"
        )
    if quant.per_layer_bits is not None and len(quant.per_layer_bits) != n_conv:
        raise ValueError(
            f"per_layer_bits has {len(quant.per_layer_bits)} entries but "
            f"{topo.name} has {n_conv} conv layers"
        )
    budget = DEFAULT_VMEM_BUDGET if vmem_budget is None else vmem_budget
    if budget < 0:
        raise ValueError(
            f"vmem_budget must be >= 0 (0 disables fusion), got {vmem_budget}"
        )

    graph = _cached_dpn(topo, quant.stream_bits)
    assignment = _cached_layout(topo, quant.stream_bits, n_stages)
    conv_params, w_scales = _bake_conv_params(params["conv"], quant, dev)
    if quant.int8_compute:
        # Layer i's input stream is layer i-1's quantized output; layer 0
        # quantizes the frame onto its own stream grid.
        int8_scales = tuple(
            Int8Scales(in_bits=quant.conv_act_bits(max(i - 1, 0)), w_scale=w_scales[i])
            for i in range(n_conv)
        )
    else:
        int8_scales = ()
    elem_bytes = plan_elem_bytes(quant)
    per_layer_act = tuple(quant.conv_act_bits(i) for i in range(n_conv))

    stages = []
    h, w = topo.input_shape
    c = topo.input_channels
    for s in range(n_stages):
        idxs = tuple(assignment.layers_of_stage(s))
        specs = tuple(topo.conv_layers[i] for i in idxs)
        in_shape = (h, w, c)
        for spec in specs:
            h, w = spec.out_hw(h, w)
            c = spec.n_out
        groups = plan_fusion_groups(
            topo, idxs, vmem_budget=budget, elem_bytes=elem_bytes
        )
        card_smem = launches = ()
        if dev.type == "cuda":
            groups = card_fusion_groups(
                topo, idxs, groups, elem_bytes=elem_bytes, block_r=block_r
            )
            card_smem = tuple(
                card_group_cost(topo, g.layers, g.block_rows, elem_bytes=elem_bytes,
                                block_r=block_r)[1]
                for g in groups
            )
            launches = tuple(card_launch(topo, g, elem_bytes=elem_bytes, block_r=block_r)
                             for g in groups)
        local_groups = tuple(
            (tuple(li - idxs[0] for li in g.layers), g.block_rows)
            for g in groups
        )
        stages.append(
            CompiledStage(
                index=s,
                conv_layers=idxs,
                specs=specs,
                fn=emit_conv_stage(
                    specs,
                    act_bits=(
                        tuple(per_layer_act[i] for i in idxs)
                        if quant.mixed_bitwidth
                        else quant.act_bits
                    ),
                    int8_scales=(
                        tuple(int8_scales[i] for i in idxs)
                        if quant.int8_compute
                        else None
                    ),
                    block_r=block_r,
                    groups=local_groups,
                ),
                cost_flops=assignment.stage_costs[s],
                groups=groups,
                io=StageIOSpec(in_shape=in_shape, out_shape=(h, w, c)),
                card_smem=card_smem,
                launches=launches,
            )
        )

    conv_params = _kmajor_params(conv_params, (g for st in stages for g in st.launches))
    head_fn, fc_params = _emit_head(
        params["fc"], quant, dev, head_in_bits=per_layer_act[-1],
        fc_act=topo.fc_act,
    )
    return CompiledDHM(
        topo=topo,
        quant=quant,
        device=dev,
        graph=graph,
        assignment=assignment,
        stages=tuple(stages),
        conv_params=conv_params,
        head_fn=head_fn,
        fc_params=fc_params,
        vmem_budget=budget,
        block_r=block_r,
        int8_scales=int8_scales,
    )
