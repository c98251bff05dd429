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
``F.max_pool2d`` with the VALID floor; quantization goes through
``fake_quant_ste``. On a CUDA tensor these run cuDNN convs: a caller that
compares them with a kernel turns cuDNN's TF32 off first.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.quant.fixed_point import fake_quant_ste
from repro_torch.kernels.stream_conv.epilogue import (
    ACTS,
    normalize_pool,
    stream_quant_spec,
)
from repro_torch.kernels.stream_conv.halo import same_pads


def _conv_nhwc(x, w, *, stride: int, padding: str) -> torch.Tensor:
    k = w.shape[0]
    x = x.to(torch.float32)
    if padding == "SAME":
        ph = same_pads(x.shape[1], stride, k)
        pw = same_pads(x.shape[2], stride, k)
        x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    elif padding != "VALID":
        raise ValueError(f"unknown padding {padding!r}")
    y = F.conv2d(
        x.permute(0, 3, 1, 2),
        w.to(torch.float32).permute(3, 2, 0, 1),
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
) -> torch.Tensor:
    """Unfused conv -> bias -> act -> NxN/stride-s max-pool -> fake-quant
    composition."""
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}")
    pw, ps = normalize_pool(pool, pool_stride)
    y = _conv_nhwc(x, w, stride=stride, padding=padding)
    y = y + b.to(torch.float32)
    if act == "relu":
        y = F.relu(y)
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
) -> torch.Tensor:
    """Plain rendering of a fusion group: the per-layer
    ``stream_conv_block_ref`` chain."""
    layers = tuple(layers)
    bits = act_bits if isinstance(act_bits, tuple) else (act_bits,) * len(layers)
    for i, (layer, w, b) in enumerate(zip(layers, weights, biases)):
        x = stream_conv_block_ref(
            x, w, b, padding=layer.padding, stride=layer.stride,
            act=layer.act, pool=layer.pool, pool_stride=layer.pool_stride,
            act_bits=bits[i],
        )
    return x
