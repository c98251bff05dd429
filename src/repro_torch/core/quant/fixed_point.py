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
import functools
import math

import numpy as np
import torch

from repro_torch.kernels.backends import constant_on

# float32(1 / ln 2): the constant XLA's float32 log2 lowering multiplies
# the natural log by (see ``ceil_log2``).
_INV_LN2 = np.float32(1.0 / math.log(2.0))
# The exponent of every value at or below the clamp 1e-12 (2^-39.86).
_EXP_MIN = -39


@functools.lru_cache(maxsize=None)
def _exponent_steps() -> np.ndarray:
    """For k = -38..128, the least float32 ``v`` at which
    ``ceil(log(v) * _INV_LN2)`` reaches ``k``, with the log rounded
    correctly to float32 and the product and ``ceil`` in float32: the
    reference's formula (XLA's float32 ``log`` is the correctly rounded
    one wherever ``ceil`` can move). The formula is monotone and can only
    step near a power of two, so each step lies within 1,024 ulps of
    2^(k-1); it is found there, on the host, once."""
    ks = np.arange(_EXP_MIN + 1, 129)
    bits = ((ks + 126) << 23)[:, None] + np.arange(-1024, 1025)[None, :]
    v = bits.astype(np.int32).view(np.float32)
    log32 = np.log(v.astype(np.float64)).astype(np.float32)
    e = np.ceil(log32 * _INV_LN2)
    first = np.argmax(e >= ks[:, None], axis=1)
    rows = np.arange(ks.size)
    assert (e[rows, first] >= ks).all() and (first > 0).all()
    return v[rows, first]


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
    """Quantize to integer codes (int32) with round-to-nearest-even.

    NaN gives code 0 on every device, as the reference's float -> int
    conversion (XLA's) gives it. C++ leaves the cast of NaN undefined: the
    card's conversion gives 0, an x86 CPU's INT_MIN, so only a tensor off
    the card has its NaNs set to 0 first (no extra launch on the card)."""
    q = torch.clamp(torch.round(x / spec.scale), spec.qmin, spec.qmax)
    return nan_codes_to_zero(q).to(torch.int32)


def nan_codes_to_zero(q: torch.Tensor) -> torch.Tensor:
    """The card's float -> int conversion of NaN (0), made explicit where
    the tensor lies elsewhere; a CUDA tensor is returned as it is."""
    return q if q.is_cuda else torch.nan_to_num(q, nan=0.0)


def dequantize_fixed(q: torch.Tensor, spec: FixedPointSpec) -> torch.Tensor:
    return q.to(torch.float32) * spec.scale


def fake_quant(x: torch.Tensor, spec: FixedPointSpec) -> torch.Tensor:
    """Quantize-dequantize round trip (no gradient defined)."""
    return dequantize_fixed(quantize_fixed(x, spec), spec)


class _STE(torch.autograd.Function):
    """clip(round(x / scale), qmin, qmax) * scale forward; straight-through
    gradient inside the representable range, zero outside. ``scale`` is a
    float or a 0-d tensor on x's device (a power of two either way, so the
    division and the products are exact and both give the same bits)."""

    @staticmethod
    def forward(ctx, x, scale, qmin: float, qmax: float):
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


def ceil_log2(x: torch.Tensor) -> torch.Tensor:
    """``ceil(log2(max(max|x|, 1e-12)))`` in float32, as the reference
    computes it, as a 0-d float32 tensor on x's device: no value is read
    on the host.

    The reference's ``jnp.log2`` lowers on XLA to ``log(x) * (1 / ln 2)``
    in float32, which is not the correctly rounded log2: at some exact
    powers of two it lands one float32 step below the integer (2^-15
    gives -14.999999), and for negative exponents ``ceil`` then moves up
    by one (2^-15, 2^-13, ...). The exponent is therefore taken the same
    way here (:func:`ceil_log2_each`), so the baked Q-formats match the
    reference's exactly, on the CPU and on the card.
    """
    return ceil_log2_each(x.detach().abs().max().to(torch.float32))


def ceil_log2_each(v: torch.Tensor) -> torch.Tensor:
    """:func:`ceil_log2`'s formula on each element of the float32 tensor
    ``v`` (>= 0): ``ceil(log(max(v, 1e-12)) * float32(1 / ln 2))`` with
    the log correctly rounded to float32, as XLA's float32 formula gives
    it at every float32 within 1,024 ulps of each power of two from
    2^-126 to 2^127 (``tests/test_torch_train_graph.py``). It is taken as
    the number of the formula's steps (:func:`_exponent_steps`) at or
    below ``v``, so every device gives the same exponent: the card's own
    float32 ``logf`` moves it by one at 106 values near powers of two
    (``tests/test_torch_train_graph_card.py``). NaN and inf pass through
    as the formula passes them.
    """
    steps = constant_on("exponent steps", v.device, lambda: torch.from_numpy(_exponent_steps()))
    e = torch.bucketize(v, steps, right=True).to(torch.float32) + _EXP_MIN
    return torch.where(torch.isfinite(v), e, v)


def _ceil_log2(x: torch.Tensor) -> int:
    """The host's view of :func:`ceil_log2` (one synchronisation): for the
    static ``FixedPointSpec`` of a forward-only bake."""
    return int(ceil_log2(x))


def dynamic_spec(x: torch.Tensor, bits: int) -> FixedPointSpec:
    """The STATIC ``FixedPointSpec`` whose pow2 scale equals the scale
    ``fake_quant_dynamic`` derives for this tensor (the reference's
    float32 ``log2`` -> ``ceil`` exponent, not ``for_tensor``'s)."""
    return FixedPointSpec(bits=bits, frac_bits=(bits - 1) - _ceil_log2(x))


def fake_quant_dynamic(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Fake-quant on the power-of-two scale derived from the live tensor
    max, with STE gradients, computed where ``x`` lives: the exponent
    (:func:`ceil_log2`) and the scale ``2^(m - (bits - 1))`` stay on the
    device, so a training step that bakes its weights through this reads
    nothing on the host and can be captured in a CUDA graph. The scale is
    the exact power of two (``torch.ldexp``; the reference's ``jnp.exp2``
    is off the pow2 grid on XLA:CPU for exponents outside about
    [-14, 12])."""
    m = ceil_log2(x)
    scale = torch.ldexp(torch.ones_like(m), m - (bits - 1)).to(x.dtype)
    return _STE.apply(x, scale, float(-(2 ** (bits - 1))), float(2 ** (bits - 1) - 1))
