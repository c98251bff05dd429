"""Plain PyTorch versions of the streaming conv kernels.

``stream_conv2d_ref`` is a plain VALID conv2d (NHWC x HWIO -> NHWC) with a
configurable stride. ``stream_conv_block_ref`` composes the UNFUSED actor
chain (conv, + bias, activation, NxN/stride-s max-pool, feature-stream
fake-quant) as separate PyTorch ops: it is the plain version of the
single-layer kernel. ``stream_conv_pyramid_ref`` chains it per layer: the
plain version of the pyramid kernel (fusion is a scheduling decision, not
a semantic one).

The convs go through ``F.conv2d`` on NCHW views. SAME padding is applied
explicitly with XLA's rule (``halo.same_pads``: total = max((ceil(d/s) -
1)*s + k - d, 0), low = total // 2), because ``padding="same"`` pads
differently for even windows and refuses stride > 1. Pooling is
``F.max_pool2d`` with the VALID floor (a tied window's gradient goes to
its first element, as under the reference's ``reduce_window``);
quantization goes through ``fake_quant_ste``. On the CPU the training
backward differentiates this composition (``ops._GroupGrad``), so its
autograd follows the reference's autodiff too (``relu`` as ``max(y,
0)``); on the card the backward kernels (``csrc/stream_conv_bwd.cu``)
give the same semantics, and this composition is what their tests hold
them to. On a CUDA tensor these run cuDNN convs: a caller that compares
them with a kernel turns cuDNN's TF32 off first.

With ``int8_scales`` the conv is the true-integer rendering: int8 input
codes times int8 weight codes, summed exactly. ``F.conv2d`` has no
integer path, so the sum is taken in float64, where every such sum is an
exact integer (far below 2^53): the reference's int32 accumulator, on
every device. One exact pow2 multiply then dequantizes it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.quant.fixed_point import fake_quant_ste, quantize_fixed
from repro_torch.kernels.stream_conv.epilogue import (
    ACTS,
    normalize_pool,
    stream_quant_spec,
)
from repro_torch.kernels.stream_conv.halo import same_pads


def _conv_nhwc(x, w, *, stride: int, padding: str,
               dtype=torch.float32) -> torch.Tensor:
    k = w.shape[0]
    x = x.to(dtype)
    if padding == "SAME":
        ph = same_pads(x.shape[1], stride, k)
        pw = same_pads(x.shape[2], stride, k)
        x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    elif padding != "VALID":
        raise ValueError(f"unknown padding {padding!r}")
    y = F.conv2d(
        x.permute(0, 3, 1, 2),
        w.to(dtype).permute(3, 2, 0, 1),
        stride=stride,
    )
    return y.permute(0, 2, 3, 1)


def stream_conv2d_ref(
    x: torch.Tensor, w: torch.Tensor, *, stride: int = 1
) -> torch.Tensor:
    """x: (B, H, W, C); w: (K, K, C, N). VALID, stride ``stride`` ->
    (B, (H-K)//s+1, (W-K)//s+1, N)."""
    return _conv_nhwc(x, w, stride=stride, padding="VALID").contiguous()


def stream_conv_block_ref(
    x: torch.Tensor,  # (B, H, W, C)
    w: torch.Tensor,  # (K, K, C, N) HWIO
    b: torch.Tensor,  # (N,)
    *,
    padding: str = "VALID",
    stride: int = 1,
    act: str = "none",
    pool: int = 0,
    pool_stride: int | None = None,
    act_bits: int | None = None,
    int8_scales=None,
) -> torch.Tensor:
    """Unfused conv -> bias -> act -> NxN/stride-s max-pool -> fake-quant
    composition.

    ``int8_scales`` (an ``epilogue.Int8Scales``) switches the conv to the
    true-integer rendering: the input is quantized onto its stream grid as
    int8 codes (exact for on-grid values), ``w`` must already be integer
    weight codes, and the exact integer accumulator is dequantized with
    ``deq_scale`` before the bias/act/pool/quant chain.
    """
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}")
    pw, ps = normalize_pool(pool, pool_stride)
    if int8_scales is not None:
        if w.dtype.is_floating_point or not w.dtype.is_signed:
            raise ValueError(
                f"int8_scales given but weights are {w.dtype}, not int codes"
            )
        qx = (
            quantize_fixed(x, int8_scales.in_spec).to(torch.int8)
            if x.is_floating_point()
            else x
        )
        acc = _conv_nhwc(qx, w, stride=stride, padding=padding,
                         dtype=torch.float64)
        y = acc.to(torch.float32) * int8_scales.deq_scale
    else:
        y = _conv_nhwc(x, w, stride=stride, padding=padding)
    y = y + b.to(torch.float32)
    if act == "relu":
        # max(y, 0) as the reference writes it (``jnp.maximum``): the same
        # values as F.relu, and autograd gives an exact zero half the
        # gradient, as JAX's does (F.relu gives it none).
        y = torch.maximum(y, y.new_zeros(()))
    elif act == "tanh":
        y = torch.tanh(y)
    if pw:
        y = F.max_pool2d(
            y.permute(0, 3, 1, 2), kernel_size=pw, stride=ps
        ).permute(0, 2, 3, 1)
    if act_bits is not None:
        y = fake_quant_ste(y, stream_quant_spec(act_bits))
    return y.contiguous()


def stream_conv_pyramid_ref(
    x: torch.Tensor,
    weights,  # per layer (K, K, C, N)
    biases,  # per layer (N,)
    *,
    layers,  # PyramidLayer per layer (padding/stride/act/pool/pool_stride)
    act_bits=None,  # int | None | per-layer tuple
    int8_scales=None,  # None | per-layer tuple of Int8Scales
) -> torch.Tensor:
    """Plain rendering of a fusion group: the per-layer
    ``stream_conv_block_ref`` chain (with ``int8_scales``, each layer
    re-quantizes its on-grid input onto its own stream grid: exact)."""
    layers = tuple(layers)
    bits = act_bits if isinstance(act_bits, tuple) else (act_bits,) * len(layers)
    for i, (layer, w, b) in enumerate(zip(layers, weights, biases)):
        x = stream_conv_block_ref(
            x, w, b, padding=layer.padding, stride=layer.stride,
            act=layer.act, pool=layer.pool, pool_stride=layer.pool_stride,
            act_bits=bits[i],
            int8_scales=None if int8_scales is None else int8_scales[i],
        )
    return x
