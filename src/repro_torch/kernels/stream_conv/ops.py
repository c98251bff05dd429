"""Public wrappers for the streaming conv kernels.

``stream_conv2d`` is the bare conv; ``stream_conv_block`` is the fused
conv -> bias -> activation -> max-pool actor chain (one DHM pipeline
stage); ``stream_conv_pyramid`` streams a whole fusion group of such
layers through one kernel launch.

Each wrapper validates its arguments the same way on every device, then
dispatches on the device of ``x``: a CUDA tensor goes to the hand-written
kernel (``conv.py``) and the call raises if the kernel cannot take it; a
CPU tensor goes to the plain PyTorch version (``ref.py``). There is no
other path and no fallback between the two. Each call of a kernel or a
plain version is also logged to ``probe`` (for the plan verifier).

A call that autograd must see through (grad mode on, and ``x``, a weight
or a bias requiring grad) goes through :class:`_GroupGrad`: its forward is
the same dispatch, so the loss comes from the kernel's output; its
backward is the counterpart of XLA's autodiff of the reference's ``ref``
composition (the JAX package has no backward kernel), dispatched the same
way: on a CUDA tensor the hand-written backward kernels
(``conv.stream_conv_pyramid_bwd_cuda``), which raise on what they cannot
take; on a CPU tensor autograd of the group's composition in plain
PyTorch ops, recomputed. Int8 calls are forward-only: asking them for a
gradient raises.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import probe
from repro_torch.kernels.backends import on_cuda
from repro_torch.kernels.stream_conv.conv import (
    stream_conv_fused_cuda,
    stream_conv_pyramid_bwd_cuda,
    stream_conv_pyramid_cuda,
)
from repro_torch.kernels.stream_conv.epilogue import (
    normalize_pool,
    quantize_stream,
    validate_epilogue,
)
from repro_torch.kernels.stream_conv import ref as _ref
from repro_torch.kernels.stream_conv.halo import (
    PyramidLayer,
    as_pyramid_layers,
    group_geometry,
    padded_frame,
    same_pads,
)
from repro_torch.kernels.stream_conv.ref import (
    stream_conv_block_ref,
    stream_conv_pyramid_ref,
)


def _pad_same(x: torch.Tensor, k: int, stride: int = 1) -> torch.Tensor:
    """SAME pads on the host side with XLA's convention — per dim, total =
    max((ceil(d/s) - 1)*s + k - d, 0), low = total//2, high = total - low —
    so strided and even-K results match the reference exactly."""
    ph = same_pads(x.shape[1], stride, k)
    pw = same_pads(x.shape[2], stride, k)
    return F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))


def _validate_fused(x, w, b, *, padding, stride, act, pool, pool_stride,
                    act_bits) -> None:
    """The reference's argument checks (ops + the Pallas wrapper), made
    before dispatch so both devices raise the same errors."""
    k = w.shape[0]
    if w.ndim != 4 or w.shape[1] != k:
        raise ValueError(f"only square kernels, got {tuple(w.shape)}")
    if padding not in ("SAME", "VALID"):
        raise ValueError(padding)
    if w.shape[2] != x.shape[3]:
        raise ValueError(
            f"w_taps {(k * k, w.shape[2], w.shape[3])} inconsistent with "
            f"k={k}, C={x.shape[3]}"
        )
    n = w.shape[3]
    if tuple(b.shape) != (n,):
        raise ValueError(f"bias must be ({n},), got {tuple(b.shape)}")
    if stride < 1:
        raise ValueError(f"conv stride must be >= 1, got {stride}")
    validate_epilogue(act, pool, pool_stride, act_bits)
    pw, _ = normalize_pool(pool, pool_stride)
    h, wd = padded_frame(x.shape[1], x.shape[2], k, stride, padding)
    h_out, w_out = (h - k) // stride + 1, (wd - k) // stride + 1
    if h_out <= 0 or w_out <= 0:
        raise ValueError(f"image {h}x{wd} too small for k={k}, stride={stride}")
    if pw and (h_out < pw or w_out < pw):
        raise ValueError(f"conv output {h_out}x{w_out} too small for {pw}x{pw} pool")


def _validate_int8(int8_scales, act_bits, w) -> None:
    if int8_scales is None:
        return
    if act_bits is None:
        raise ValueError("int8_scales requires act_bits (the stream grid)")
    if w.dtype.is_floating_point or not w.dtype.is_signed:
        raise ValueError(
            f"int8_scales requires int8 weight codes, got {w.dtype} — bake "
            "weights with quantize_fixed(w, dynamic_spec(w, bits))"
        )


def _as_codes(x: torch.Tensor, in_bits: int) -> torch.Tensor:
    """Quantize a float frame onto the input stream grid as int8 codes
    BEFORE the launch (the reference does it outside its pallas_call too),
    under the span ``repro_torch.dhm.quantize``: the kernel's resident
    frame is 1 byte/element. Integer input is taken as codes already."""
    if not x.is_floating_point():
        return x
    with probe.span("repro_torch.dhm.quantize"):
        return quantize_stream(x, in_bits)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _refuse_int8_grad(int8_scales) -> None:
    if int8_scales is not None:
        raise ValueError(
            "int8 stream-conv calls are forward-only: integer codes have no "
            "gradient (run them under torch.no_grad() or inference_mode)"
        )


class _GroupGrad(torch.autograd.Function):
    """One fp32 / fake-quant fusion group (or single layer) with a gradient.

    ``run(x, weights, biases)`` is the wrapper's own dispatch: the kernel on
    a CUDA tensor, the plain version on a CPU one. The backward gives what
    autograd of ``ref.py``'s per-layer composition (conv, + bias, act,
    ``F.max_pool2d``, ``fake_quant_ste``) gives: a tied pool window's
    gradient to its first element, the clipped fake-quant elements masked,
    relu's zero half the gradient. On a CUDA tensor it is the backward
    kernels (``conv.stream_conv_pyramid_bwd_cuda``: the forward recomputed
    from the saved input, then dx and dW over the whole batch), logged as
    the dispatch ``stream_conv_pyramid_bwd`` in the forward caller's
    ``probe`` log (autograd runs a card's backward on its own thread). On a
    CPU tensor it recomputes the composition from the saved input and
    returns ``torch.autograd.grad`` of it, calling ``ref.py`` directly, so
    no plain-version dispatch is logged.
    """

    @staticmethod
    def forward(ctx, run, layers, bits, x, *params):
        n = len(params) // 2
        ctx.layers, ctx.bits, ctx.log = layers, bits, probe.active()
        ctx.save_for_backward(x, *params)
        return run(x, params[:n], params[n:])

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[3:]
        n = (len(saved) - 1) // 2
        if on_cuda(g):
            x, weights, biases = saved[0], saved[1 : 1 + n], saved[1 + n :]
            with probe.attached(ctx.log):
                with probe.dispatch("stream_conv_pyramid_bwd", plain=False):
                    dx, dws, dbs = stream_conv_pyramid_bwd_cuda(
                        x.contiguous(), [w.contiguous() for w in weights],
                        [b.contiguous() for b in biases], g.contiguous(),
                        layers=ctx.layers, act_bits=ctx.bits, need_dx=need[0],
                    )
            grads = (dx, *dws, *dbs)
            return (None, None, None, *(t if r else None for t, r in zip(grads, need)))
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(r) for t, r in zip(saved, need)]
            y = _ref.stream_conv_pyramid_ref(
                leaves[0], leaves[1 : 1 + n], leaves[1 + n :],
                layers=ctx.layers, act_bits=ctx.bits,
            )
            grads = iter(torch.autograd.grad(
                y, [t for t, r in zip(leaves, need) if r], g
            ))
        return (None, None, None, *(next(grads) if r else None for r in need))


def stream_conv2d(
    x: torch.Tensor,  # (B, H, W, C)
    w: torch.Tensor,  # (K, K, C, N) HWIO
    *,
    padding: str = "VALID",
    stride: int = 1,
    block_r: int = 8,
    block_w: int = 0,
) -> torch.Tensor:
    """Streaming conv2d, stride ``stride``, no epilogue. SAME pads on the
    host side."""
    zero_b = torch.zeros((w.shape[3],), dtype=torch.float32, device=x.device)
    return stream_conv_block(
        x, w, zero_b, padding=padding, stride=stride, act="none", pool=0,
        block_r=block_r, block_w=block_w,
    )


def stream_conv_block(
    x: torch.Tensor,  # (B, H, W, C)
    w: torch.Tensor,  # (K, K, C, N) HWIO
    b: torch.Tensor,  # (N,)
    *,
    padding: str = "VALID",
    stride: int = 1,
    act: str = "relu",
    pool: int = 2,
    pool_stride: int | None = None,
    act_bits: int | None = None,
    int8_scales=None,
    block_r: int = 8,
    block_w: int = 0,
    w_kmajor: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fused conv -> bias -> act -> NxN/stride-s-max-pool block (one DHM
    pipeline stage). ``pool=0`` disables pooling, ``pool_stride=None``
    means window == stride; ``act_bits`` quantizes the output feature
    stream inside the same fused epilogue. ``block_r`` is the conv rows a
    CUDA block streams and ``block_w`` the conv columns of one column
    strip (0 = the full width), both rounded to the halo rule's multiple
    as the reference rounds them; the launcher narrows the strips further
    where a block would not fit in shared memory. The plain version
    computes the whole frame at once and reads neither.

    ``int8_scales`` (an ``epilogue.Int8Scales``) switches to true integer
    arithmetic: ``w`` must be int8 weight codes, the input is quantized
    onto its stream grid (exact for on-grid values), and the conv sums
    int8 x int8 products into int32 before the requantizing epilogue —
    fp32 values on the ``act_bits`` grid out. ``w_kmajor`` is ``w`` as the
    card kernel's wgmma path reads it (``conv.kmajor_weights``), laid out
    once by a plan; the card lays it out at each call where it is not
    given, the plain version never reads it."""
    _validate_fused(
        x, w, b, padding=padding, stride=stride, act=act, pool=pool,
        pool_stride=pool_stride, act_bits=act_bits,
    )
    _validate_int8(int8_scales, act_bits, w)
    run = functools.partial(
        _run_block, padding=padding, stride=stride, act=act, pool=pool,
        pool_stride=pool_stride, act_bits=act_bits, int8_scales=int8_scales,
        block_r=block_r, block_w=block_w, w_kmajor=w_kmajor,
    )
    if _needs_grad(x, w, b):
        _refuse_int8_grad(int8_scales)
        layer = PyramidLayer(padding=padding, stride=stride, act=act, pool=pool,
                             pool_stride=pool_stride)
        return _GroupGrad.apply(run, (layer,), (act_bits,), x, w, b)
    return run(x, (w,), (b,))


def _run_block(x, ws, bs, *, padding, stride, act, pool, pool_stride,
               act_bits, int8_scales, block_r, block_w, w_kmajor) -> torch.Tensor:
    """``stream_conv_block``'s dispatch, on validated arguments."""
    (w,), (b,) = ws, bs
    name = "stream_conv_fused" if int8_scales is None else "stream_conv_fused_int8"
    if not on_cuda(x):
        with probe.dispatch(name, plain=True):
            return stream_conv_block_ref(
                x, w, b, padding=padding, stride=stride, act=act, pool=pool,
                pool_stride=pool_stride, act_bits=act_bits,
                int8_scales=int8_scales,
            )
    if int8_scales is not None:
        x = _as_codes(x, int8_scales.in_bits)  # pad zeros below are code 0
    if padding == "SAME":
        x = _pad_same(x, w.shape[0], stride)
    with probe.dispatch(name, plain=False):
        return stream_conv_fused_cuda(
            x.contiguous(), w.contiguous(), b.contiguous(), stride=stride,
            act=act, pool=pool, pool_stride=pool_stride, act_bits=act_bits,
            int8_scales=int8_scales, block_r=block_r, block_w=block_w,
            w_kmajor=w_kmajor,
        )


def stream_conv_pyramid(
    x: torch.Tensor,  # (B, H, W, C0)
    weights,  # sequence of (K, K, C, N) HWIO, one per layer
    biases,  # sequence of (N,), one per layer
    *,
    layers,  # sequence of layer specs (padding/stride/act/pool[/pool_stride])
    act_bits=None,  # int | None | per-layer tuple
    int8_scales=None,  # None | per-layer tuple of Int8Scales
    block_rows: int = 0,
) -> torch.Tensor:
    """Cross-layer fused conv pyramid: a whole fusion group of consecutive
    conv -> bias -> act -> pool layers as ONE kernel launch, with every
    inter-layer slab in shared memory. ``block_rows`` sets the final
    output rows one CUDA block streams (0 = whole frame; the input halo is
    the composed per-layer requirement of ``halo.group_geometry``).
    ``act_bits`` may be a per-layer tuple (mixed-bitwidth plans).

    ``int8_scales`` (per-layer tuple of ``Int8Scales``) selects true
    integer arithmetic: the frame is quantized onto layer 0's stream grid
    before the launch (1-byte frame), interior layers consume and emit
    int8 stream codes, and each ``Int8Scales.in_bits`` must name the
    previous layer's ``act_bits`` (the code chain contract)."""
    weights = tuple(weights)
    biases = tuple(biases)
    layers = tuple(layers)
    if not weights or len(weights) != len(biases) or len(weights) != len(layers):
        raise ValueError(
            f"pyramid needs matching layers/weights/biases, got "
            f"{len(layers)}/{len(weights)}/{len(biases)}"
        )
    for li, w in enumerate(weights):
        if w.ndim != 4 or w.shape[0] != w.shape[1]:
            raise ValueError(
                f"pyramid layer {li}: only square HWIO kernels, got "
                f"{tuple(w.shape)}"
            )
    bits = (
        act_bits if isinstance(act_bits, tuple)
        else (act_bits,) * len(layers)
    )
    if len(bits) != len(layers):
        raise ValueError(
            f"act_bits tuple has {len(bits)} entries for "
            f"{len(layers)} layers"
        )
    if int8_scales is not None:
        int8_scales = tuple(int8_scales)
        if len(int8_scales) != len(layers):
            raise ValueError(
                f"int8_scales has {len(int8_scales)} entries for "
                f"{len(layers)} layers"
            )
        for li, (sc, w) in enumerate(zip(int8_scales, weights)):
            _validate_int8(sc, bits[li], w)
            if li and sc.in_bits != bits[li - 1]:
                raise ValueError(
                    f"pyramid layer {li}: in_bits={sc.in_bits} must equal "
                    f"the previous layer's act_bits={bits[li - 1]} (the "
                    "inter-layer code chain)"
                )
    pyr = as_pyramid_layers(layers)
    run = functools.partial(_run_pyramid, pyr=pyr, bits=bits,
                            int8_scales=int8_scales, block_rows=block_rows)
    if _needs_grad(x, *weights, *biases):
        _refuse_int8_grad(int8_scales)
        return _GroupGrad.apply(run, pyr, bits, x, *weights, *biases)
    return run(x, weights, biases)


def _run_pyramid(x, weights, biases, *, pyr, bits, int8_scales,
                 block_rows) -> torch.Tensor:
    """``stream_conv_pyramid``'s dispatch, on validated arguments."""
    name = "stream_conv_pyramid" if int8_scales is None else "stream_conv_pyramid_int8"
    if not on_cuda(x):
        with probe.dispatch(name, plain=True):
            return stream_conv_pyramid_ref(
                x, weights, biases, layers=pyr, act_bits=bits,
                int8_scales=int8_scales,
            )
    if int8_scales is not None:
        x = _as_codes(x, int8_scales[0].in_bits)
    b_, h, w, c = x.shape
    geom = group_geometry(
        h, w, c, pyr, tuple(wt.shape[0] for wt in weights),
        tuple(wt.shape[3] for wt in weights), block_rows=block_rows,
    )
    with probe.dispatch(name, plain=False):
        return stream_conv_pyramid_cuda(
            x.contiguous(), [wt.contiguous() for wt in weights],
            [bs.contiguous() for bs in biases], geom=geom, act_bits=bits,
            int8_scales=int8_scales,
        )
