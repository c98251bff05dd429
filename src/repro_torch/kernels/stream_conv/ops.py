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
    block_r: int = 8,
) -> torch.Tensor:
    """Fused conv -> bias -> act -> NxN/stride-s-max-pool block (one DHM
    pipeline stage). ``pool=0`` disables pooling, ``pool_stride=None``
    means window == stride; ``act_bits`` quantizes the output feature
    stream inside the same fused epilogue. ``block_r`` is the conv rows a
    CUDA block streams (rounded to the halo rule's multiple)."""
    _validate_fused(
        x, w, b, padding=padding, stride=stride, act=act, pool=pool,
        pool_stride=pool_stride, act_bits=act_bits,
    )
    if not _on_cuda(x):
        return stream_conv_block_ref(
            x, w, b, padding=padding, stride=stride, act=act, pool=pool,
            pool_stride=pool_stride, act_bits=act_bits,
        )
    if padding == "SAME":
        x = _pad_same(x, w.shape[0], stride)
    return stream_conv_fused_cuda(
        x.contiguous(), w.contiguous(), b.contiguous(), stride=stride,
        act=act, pool=pool, pool_stride=pool_stride, act_bits=act_bits,
        block_r=block_r,
    )


def stream_conv_pyramid(
    x: torch.Tensor,  # (B, H, W, C0)
    weights,  # sequence of (K, K, C, N) HWIO, one per layer
    biases,  # sequence of (N,), one per layer
    *,
    layers,  # sequence of layer specs (padding/stride/act/pool[/pool_stride])
    act_bits=None,  # int | None | per-layer tuple
    block_rows: int = 0,
) -> torch.Tensor:
    """Cross-layer fused conv pyramid: a whole fusion group of consecutive
    conv -> bias -> act -> pool layers as ONE kernel launch, with every
    inter-layer slab in shared memory. ``block_rows`` sets the final
    output rows one CUDA block streams (0 = whole frame; the input halo is
    the composed per-layer requirement of ``halo.group_geometry``).
    ``act_bits`` may be a per-layer tuple (mixed-bitwidth plans)."""
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
    pyr = as_pyramid_layers(layers)
    if not _on_cuda(x):
        return stream_conv_pyramid_ref(
            x, weights, biases, layers=pyr, act_bits=bits
        )
    b_, h, w, c = x.shape
    geom = group_geometry(
        h, w, c, pyr, tuple(wt.shape[0] for wt in weights),
        tuple(wt.shape[3] for wt in weights), block_rows=block_rows,
    )
    return stream_conv_pyramid_cuda(
        x.contiguous(), [wt.contiguous() for wt in weights],
        [bs.contiguous() for bs in biases], geom=geom, act_bits=bits,
    )
