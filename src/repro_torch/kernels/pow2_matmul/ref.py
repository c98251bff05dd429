"""Plain PyTorch versions of the pow2-quantized matmul.

Semantics: ``out = x @ decode(codes) * scale`` where codes are 4-bit
(sign | magnitude) pow2 codes packed two per byte along N, and ``scale``
is the per-output-channel float scale. ``pow2_matmul_ref`` decodes to
unit-scale float32 and multiplies by the scale after the product, as the
kernel does; ``pow2_matmul_int_ref`` is the true-integer rendering.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant.fixed_point import quantize_fixed
from repro_torch.core.quant.packing import unpack_codes_u4
from repro_torch.core.quant.pow2 import decode_pow2


def pow2_matmul_ref(
    x: torch.Tensor,  # (M, K) float
    packed: torch.Tensor,  # (K, ceil(N/2)) uint8
    scale: torch.Tensor,  # (N,) float32 — N is the true layer width
) -> torch.Tensor:
    codes = unpack_codes_u4(packed)  # (K, 2 * ceil(N/2))
    w = decode_pow2(codes, torch.ones((), dtype=torch.float32, device=codes.device))
    acc = torch.matmul(x.to(torch.float32), w)
    # Odd N: the pad column holds zero codes; slice it off before scaling.
    n = scale.shape[0]
    return acc[:, :n] * scale[None, :]


def pow2_matmul_int_ref(
    x: torch.Tensor,  # (M, K) float on the x_spec grid (or int8 codes)
    packed: torch.Tensor,  # (K, ceil(N/2)) uint8
    scale: torch.Tensor,  # (N,) float32 — N is the true layer width
    *,
    x_spec,  # FixedPointSpec of x's grid
) -> torch.Tensor:
    """True-integer rendering: the pow2 codes decode to INTEGER shift
    weights (0 or ±2^(m-1), magnitude <= 64 — int8), the activations
    quantize onto their fixed-point grid as int8 codes, and one integer
    product accumulates; the activation scale times the per-channel
    scale folds in afterwards. The product is taken in float64, where
    these integer sums are exact (far below 2^53), so it equals the
    reference's int32 accumulator on every device."""
    codes = unpack_codes_u4(packed)  # (K, 2 * ceil(N/2)) uint8
    mag = (codes & 0x7).to(torch.int64)
    wi = torch.where(mag == 0, 0, 1 << (mag - 1).clamp(min=0))
    wi = torch.where((codes & 0x8) != 0, -wi, wi).to(torch.int8)
    qx = (
        quantize_fixed(x, x_spec).to(torch.int8)
        if x.is_floating_point()
        else x
    )
    acc = torch.matmul(qx.to(torch.float64), wi.to(torch.float64))
    n = scale.shape[0]
    return acc[:, :n].to(torch.float32) * (x_spec.scale * scale[None, :])
