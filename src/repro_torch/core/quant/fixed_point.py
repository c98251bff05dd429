"""Fixed-point Q-format quantization (paper §4.1).

The paper represents data and parameters in short fixed-point formats
(3 bits for LeNet5, 6 bits for SVHN/CIFAR10). A ``b``-bit signed two's
complement Q(m, f) number has one sign bit, ``m`` integer bits and ``f``
fractional bits with b = 1 + m + f, representable range
[-2^m, 2^m - 2^-f] with step 2^-f.

``fake_quant_ste`` implements quantization-aware training with the
straight-through estimator (identity gradient), used for the paper's
post-bit-width-selection fine-tuning step (footnote 2).

Rounding is ``torch.round``: half to even, as ``jnp.round`` in the
reference.
"""
from __future__ import annotations

import dataclasses
import math

import torch

# float32(1 / ln 2): the constant XLA's float32 log2 lowering multiplies
# the natural log by (see ``_ceil_log2``).
_INV_LN2 = torch.tensor(1.0 / math.log(2.0), dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class FixedPointSpec:
    """A signed two's-complement fixed-point format.

    Attributes:
      bits: total bit-width, including the sign bit. Must be >= 2.
      frac_bits: number of fractional bits ``f``. The scale is ``2**-f``.
    """

    bits: int
    frac_bits: int

    def __post_init__(self) -> None:
        if self.bits < 2:
            raise ValueError(f"fixed-point needs >=2 bits, got {self.bits}")

    @property
    def int_bits(self) -> int:
        return self.bits - 1 - self.frac_bits

    @property
    def scale(self) -> float:
        return 2.0 ** (-self.frac_bits)

    @property
    def qmin(self) -> int:
        return -(2 ** (self.bits - 1))

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1

    @property
    def min_value(self) -> float:
        return self.qmin * self.scale

    @property
    def max_value(self) -> float:
        return self.qmax * self.scale

    @staticmethod
    def for_tensor(x: torch.Tensor, bits: int) -> "FixedPointSpec":
        """Choose frac_bits so the tensor's max-abs value fits (paper's
        'inferring the minimal required precision')."""
        max_abs = float(x.detach().abs().max())
        if max_abs == 0.0 or not math.isfinite(max_abs):
            return FixedPointSpec(bits=bits, frac_bits=bits - 1)
        m = math.ceil(math.log2(max_abs + 1e-12))
        return FixedPointSpec(bits=bits, frac_bits=bits - 1 - m)


def quantize_fixed(x: torch.Tensor, spec: FixedPointSpec) -> torch.Tensor:
    """Quantize to integer codes (int32) with round-to-nearest-even."""
    q = torch.round(x / spec.scale)
    return torch.clamp(q, spec.qmin, spec.qmax).to(torch.int32)


def dequantize_fixed(q: torch.Tensor, spec: FixedPointSpec) -> torch.Tensor:
    return q.to(torch.float32) * spec.scale


def fake_quant(x: torch.Tensor, spec: FixedPointSpec) -> torch.Tensor:
    """Quantize-dequantize round trip (no gradient defined)."""
    return dequantize_fixed(quantize_fixed(x, spec), spec)


class _STE(torch.autograd.Function):
    """clip(round(x / scale), qmin, qmax) * scale forward; straight-through
    gradient inside the representable range, zero outside."""

    @staticmethod
    def forward(ctx, x, scale: float, qmin: float, qmax: float):
        ctx.save_for_backward(x)
        ctx.bounds = (qmin * scale, qmax * scale)
        return torch.clamp(torch.round(x / scale), qmin, qmax) * scale

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.bounds
        inside = (x >= lo) & (x <= hi)
        return torch.where(inside, g, torch.zeros_like(g)), None, None, None


def fake_quant_ste(x: torch.Tensor, spec: FixedPointSpec) -> torch.Tensor:
    """Fake-quant with straight-through-estimator gradients (QAT)."""
    return _STE.apply(x, spec.scale, float(spec.qmin), float(spec.qmax))


def _ceil_log2(x: torch.Tensor) -> int:
    """``ceil(log2(max(max|x|, 1e-12)))`` in float32, as the reference
    computes it.

    The reference's ``jnp.log2`` lowers on XLA to ``log(x) * (1 / ln 2)``
    in float32, which is not the correctly rounded log2: at some exact
    powers of two it lands one float32 step below the integer (2^-15
    gives -14.999999), and for negative exponents ``ceil`` then moves up
    by one (2^-15, 2^-13, ...). The exponent is therefore taken
    the same way here, on the host in float32, so the baked Q-formats
    match the reference's exactly.
    """
    max_abs = x.detach().abs().max().to("cpu", torch.float32)
    m = torch.clamp(max_abs, min=1e-12)
    return int(torch.ceil(torch.log(m) * _INV_LN2))


def dynamic_spec(x: torch.Tensor, bits: int) -> FixedPointSpec:
    """The STATIC ``FixedPointSpec`` whose pow2 scale equals the scale
    ``fake_quant_dynamic`` derives for this tensor (the reference's
    float32 ``log2`` -> ``ceil`` exponent, not ``for_tensor``'s)."""
    return FixedPointSpec(bits=bits, frac_bits=(bits - 1) - _ceil_log2(x))


def fake_quant_dynamic(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Fake-quant on the power-of-two scale derived from the live tensor
    max, with STE gradients. The exponent is read on the host (one
    synchronisation per call): the port bakes quantization at compile
    time, never inside a serving step."""
    return fake_quant_ste(x, dynamic_spec(x, bits))
