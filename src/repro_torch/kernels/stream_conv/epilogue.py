"""Shared fused epilogue: bias -> activation -> NxN/stride-s max-pool ->
feature-stream fixed-point quantization.

The PyTorch counterpart of ``repro.kernels.stream_conv.epilogue``. The
CUDA kernels (``csrc/stream_conv.cu``) implement the same chain in their
write-back; this module is its plain rendering and the vocabulary both
share. The plain conv versions in ``ref.py`` keep their own independent
composition (``F.max_pool2d`` + ``fake_quant_ste``), so the epilogue is
tested against a second rendering of the same Q-format.

Pooling is a square ``pool x pool`` max window sliding with
``pool_stride`` (default: ``pool``); output dims follow the VALID
sliding-window rule ``(d - pool) // pool_stride + 1``.

``act_bits`` quantizes the inter-actor feature stream onto
``FixedPointSpec(bits, bits - 2)``: clip(round(y / scale)) * scale, with
``torch.round`` (half to even, as ``jnp.round``; the kernels use
``rintf``, never ``roundf``).

Works on any (..., H, W, N) float32 block.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.quant.fixed_point import FixedPointSpec

ACTS = ("none", "relu", "tanh")


@dataclasses.dataclass(frozen=True)
class Int8Scales:
    """Static descriptor of one conv layer's true-int8 arithmetic contract.

    ``in_bits`` names the input stream's Q-format (the producer's
    ``act_bits``); ``w_scale`` is the baked weights' static pow2 scale, so
    the int32 accumulator dequantizes with one exact pow2 multiply
    (``in_scale * w_scale``) back to the fp32 values the fake-quant plan
    computes. The int8 kernels (``csrc/stream_conv.cu``) take
    ``deq_scale`` as their dequantization factor.
    """

    in_bits: int
    w_scale: float

    @property
    def in_spec(self) -> FixedPointSpec:
        return stream_quant_spec(self.in_bits)

    @property
    def in_scale(self) -> float:
        return self.in_spec.scale

    @property
    def deq_scale(self) -> float:
        """int32 accumulator -> fp32 values (exact: pow2 * pow2)."""
        return self.in_scale * self.w_scale


def normalize_pool(pool: int, pool_stride: int | None = None) -> tuple:
    """Normalize the (pool, pool_stride) sugar into a concrete
    ``(window, stride)`` pair; ``(0, 0)`` means pooling disabled."""
    if pool is None:
        pool = 0
    if not isinstance(pool, int) or isinstance(pool, bool):
        raise ValueError(f"pool must be an int window size, got {pool!r}")
    if pool < 0:
        raise ValueError(f"pool window must be >= 0 (0 = no pool), got {pool}")
    if pool == 0:
        if pool_stride not in (None, 0):
            raise ValueError(
                f"pool_stride={pool_stride!r} given but pooling is disabled "
                "(pool=0)"
            )
        return (0, 0)
    ps = pool if pool_stride is None else pool_stride
    if not isinstance(ps, int) or isinstance(ps, bool) or ps < 1:
        raise ValueError(
            f"pool_stride must be a positive int (or None = window), got "
            f"{pool_stride!r}"
        )
    return (pool, ps)


def pool_out_dim(d: int, window: int, stride: int) -> int:
    """VALID sliding-window output length for one spatial dim."""
    return (d - window) // stride + 1


def stream_quant_spec(act_bits: int) -> FixedPointSpec:
    """The feature-stream Q-format: 1 sign bit, 1 integer bit, rest
    fractional."""
    return FixedPointSpec(bits=act_bits, frac_bits=act_bits - 2)


def validate_epilogue(
    act: str,
    pool: int,
    pool_stride: int | None = None,
    act_bits: int | None = None,
) -> None:
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}; expected one of {ACTS}")
    normalize_pool(pool, pool_stride)
    if act_bits is not None and act_bits < 2:
        raise ValueError(f"act_bits must be >= 2 (or None), got {act_bits}")


def _maxpool_window(y: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """Square max-pool over the trailing (H, W, N) dims of ``y`` via
    window*window shifted strided views."""
    h, w = y.shape[-3], y.shape[-2]
    hp = pool_out_dim(h, window, stride)
    wp = pool_out_dim(w, window, stride)
    out = None
    for di in range(window):
        for dj in range(window):
            v = y[
                ...,
                di : di + (hp - 1) * stride + 1 : stride,
                dj : dj + (wp - 1) * stride + 1 : stride,
                :,
            ]
            out = v if out is None else torch.maximum(out, v)
    return out


def quantize_stream(x: torch.Tensor, act_bits: int) -> torch.Tensor:
    """Quantize fp32 values onto the ``act_bits`` stream grid as int8
    CODES (value = code * scale). Exact (a pure representation change)
    when ``x`` already sits on the grid, which every fused-kernel boundary
    guarantees. int8 holds any stream code: ``act_bits <= 8`` is enforced
    by the compile-time ``int8_compute`` validation."""
    spec = stream_quant_spec(act_bits)
    q = torch.clamp(torch.round(x / spec.scale), spec.qmin, spec.qmax)
    return q.to(torch.int8)


def apply_epilogue(
    y: torch.Tensor, bias: torch.Tensor, *, act: str, pool: int,
    pool_stride: int | None = None, act_bits: int | None = None,
    pool_first: bool = False, codes_out: bool = False,
) -> torch.Tensor:
    """y: (..., H, W, N) f32; bias: (N,). Returns the block after
    bias + activation + optional pool x pool / pool_stride max-pool (VALID
    floor semantics) + optional feature-stream quantization.

    ``pool_first=True`` swaps the act/pool actors (bias -> max-pool ->
    activation -> quant): the order of ``cnn_apply_reference`` and of the
    cross-layer pyramid kernel. Max-pool commutes with the monotone
    activations, so both orders agree; the single-layer kernel keeps the
    paper's conv -> act -> pool order.

    ``codes_out=True`` (true-int8 pyramid interiors) returns the stream
    quantization's int8 CODES instead of the dequantized fp32 values: the
    inter-layer slab the next layer's integer product consumes. Requires
    ``act_bits``.
    """
    validate_epilogue(act, pool, pool_stride, act_bits)
    if codes_out and act_bits is None:
        raise ValueError("codes_out requires act_bits")
    pw, ps = normalize_pool(pool, pool_stride)
    y = y + bias.to(torch.float32)
    if pool_first and pw:
        y = _maxpool_window(y, pw, ps)
    if act == "relu":
        y = torch.clamp_min(y, 0.0)
    elif act == "tanh":
        y = torch.tanh(y)
    if not pool_first and pw:
        y = _maxpool_window(y, pw, ps)
    if act_bits is not None:
        spec = stream_quant_spec(act_bits)
        q = torch.clamp(torch.round(y / spec.scale), spec.qmin, spec.qmax)
        y = q.to(torch.int8) if codes_out else q * spec.scale
    return y
