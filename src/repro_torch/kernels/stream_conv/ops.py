"""Public wrappers for the streaming conv kernels.

``stream_conv2d`` is the bare conv; ``stream_conv_block`` is the fused
conv -> bias -> activation -> max-pool actor chain (one DHM pipeline
stage); ``stream_conv_pyramid`` streams a whole fusion group of such
layers through one kernel launch.

Each wrapper validates its arguments the same way on every device, then
dispatches on the device of ``x``: a CUDA tensor goes to the hand-written
kernel (``conv.py``) and the call raises if the kernel cannot take it; a
CPU tensor goes to the plain PyTorch version (``ref.py``). There is no
other path and no fallback between the two.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.stream_conv.conv import (
    stream_conv_fused_cuda,
    stream_conv_pyramid_cuda,
)
from repro_torch.kernels.stream_conv.epilogue import (
    normalize_pool,
    quantize_stream,
    validate_epilogue,
)
from repro_torch.kernels.stream_conv.halo import (
    as_pyramid_layers,
    group_geometry,
    same_pads,
)
from repro_torch.kernels.stream_conv.ref import (
    stream_conv_block_ref,
    stream_conv_pyramid_ref,
)


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {x.device}; expected cuda or cpu")


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
    h, wd = x.shape[1], x.shape[2]
    if padding == "SAME":
        h += sum(same_pads(h, stride, k))
        wd += sum(same_pads(wd, stride, k))
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
    BEFORE the launch (the reference does it outside its pallas_call too):
    the kernel's resident frame is 1 byte/element. Integer input is taken
    as codes already."""
    return quantize_stream(x, in_bits) if x.is_floating_point() else x


def stream_conv2d(
    x: torch.Tensor,  # (B, H, W, C)
    w: torch.Tensor,  # (K, K, C, N) HWIO
    *,
    padding: str = "VALID",
    stride: int = 1,
    block_r: int = 8,
) -> torch.Tensor:
    """Streaming conv2d, stride ``stride``, no epilogue. SAME pads on the
    host side."""
    zero_b = torch.zeros((w.shape[3],), dtype=torch.float32, device=x.device)
    return stream_conv_block(
        x, w, zero_b, padding=padding, stride=stride, act="none", pool=0,
        block_r=block_r,
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
) -> torch.Tensor:
    """Fused conv -> bias -> act -> NxN/stride-s-max-pool block (one DHM
    pipeline stage). ``pool=0`` disables pooling, ``pool_stride=None``
    means window == stride; ``act_bits`` quantizes the output feature
    stream inside the same fused epilogue. ``block_r`` is the conv rows a
    CUDA block streams (rounded to the halo rule's multiple).

    ``int8_scales`` (an ``epilogue.Int8Scales``) switches to true integer
    arithmetic: ``w`` must be int8 weight codes, the input is quantized
    onto its stream grid (exact for on-grid values), and the conv sums
    int8 x int8 products into int32 before the requantizing epilogue —
    fp32 values on the ``act_bits`` grid out."""
    _validate_fused(
        x, w, b, padding=padding, stride=stride, act=act, pool=pool,
        pool_stride=pool_stride, act_bits=act_bits,
    )
    _validate_int8(int8_scales, act_bits, w)
    if not _on_cuda(x):
        return stream_conv_block_ref(
            x, w, b, padding=padding, stride=stride, act=act, pool=pool,
            pool_stride=pool_stride, act_bits=act_bits,
            int8_scales=int8_scales,
        )
    if int8_scales is not None:
        x = _as_codes(x, int8_scales.in_bits)  # pad zeros below are code 0
    if padding == "SAME":
        x = _pad_same(x, w.shape[0], stride)
    return stream_conv_fused_cuda(
        x.contiguous(), w.contiguous(), b.contiguous(), stride=stride,
        act=act, pool=pool, pool_stride=pool_stride, act_bits=act_bits,
        int8_scales=int8_scales, block_r=block_r,
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
    if not _on_cuda(x):
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
    return stream_conv_pyramid_cuda(
        x.contiguous(), [wt.contiguous() for wt in weights],
        [bs.contiguous() for bs in biases], geom=geom, act_bits=bits,
        int8_scales=int8_scales,
    )
