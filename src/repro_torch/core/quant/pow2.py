"""Power-of-two ("constant-specialized multiplier") quantization (paper §4.2).

The PyTorch counterpart of ``repro.core.quant.pow2``. Two pieces:

1. ``classify_params`` — the Table 1 histogram: the fraction of quantized
   parameters that are exactly zero / ±1 / ±2^k / other.

2. The pow2-codebook weight representation: each weight is a 4-bit code
   ``(sign, magnitude-index)`` with a per-output-channel float scale:

       code 0          -> 0.0
       code m, sign s  -> (-1)^s * scale * 2^(m-1),   m in [1..7]

   Codes pack two per byte (``packing.py``); ``kernels/pow2_matmul``
   decodes them by exponent construction.

The codes are byte-identical to the reference's. The reference rounds in
the log domain, ``round(log2(mag))``, with XLA's float32 ``log2``; neither
``torch.log2`` nor ``log(x) * float32(1/ln 2)`` rounds the same way at
every midpoint 2^(e+0.5). Since ``round(log2(mag))`` only changes value
at those midpoints, the port compares ``mag`` with the six float32
thresholds at which the reference's rounding steps up (``_E_THRESHOLDS``,
read once from the reference by walking ulps around each midpoint and
pinned by ``tests/test_torch_pow2.py``).
"""
from __future__ import annotations

import dataclasses

import torch

# Number of non-zero magnitude levels per sign (3 magnitude bits, m=1..7).
POW2_LEVELS = 7
POW2_ZERO_CODE = 0
# Largest representable multiple of the scale: 2^(POW2_LEVELS-1).
POW2_MAX_MAG = 2 ** (POW2_LEVELS - 1)

# Bit patterns of the smallest float32 ``mag`` the reference's
# ``round(log2(mag))`` sends to e + 1, for e = 0..5 (the float32 nearest
# to 2^(e+0.5) is 0x3fb504f3, 0x403504f3, ...; the reference's rounding
# steps up one to two ulps either side of it).
_E_THRESHOLD_BITS = (
    0x3FB504F4, 0x403504F3, 0x40B504F5, 0x413504F2, 0x41B504F5, 0x423504F2,
)
# float32(2 ** -0.5): the reference compares float32 ``mag`` with it in
# float32 (a weakly typed Python scalar).
_ZERO_THRESHOLD_BITS = 0x3F3504F3


def _f32_from_bits(bits) -> torch.Tensor:
    return torch.tensor(bits, dtype=torch.int32).view(torch.float32)


_E_THRESHOLDS = _f32_from_bits(list(_E_THRESHOLD_BITS))
_ZERO_THRESHOLD = _f32_from_bits([_ZERO_THRESHOLD_BITS])
# |decoded value| / scale by magnitude index m: 0, then 2^(m-1).
_POW2_MAGNITUDES = torch.tensor(
    [0.0] + [2.0 ** (m - 1) for m in range(1, POW2_LEVELS + 1)],
    dtype=torch.float32,
)


@dataclasses.dataclass(frozen=True)
class ParamClassStats:
    """Fractions of quantized parameters per multiplier-specialization class
    (paper Table 1)."""

    zero: float
    one: float
    pow2: float
    other: float
    total: int

    @property
    def multiplierless(self) -> float:
        """Fraction of parameters needing no hardware multiplier."""
        return self.zero + self.one + self.pow2

    def as_percent(self) -> dict:
        return {
            "zero %": 100.0 * self.zero,
            "one %": 100.0 * self.one,
            "pow2 %": 100.0 * self.pow2,
            "other %": 100.0 * self.other,
        }


def classify_params(q_codes, frac_bits: int) -> ParamClassStats:
    """Classify integer fixed-point codes into zero/one/pow2/other.

    A code ``q`` represents the value ``q * 2**-frac_bits``; the value is
    ±1 iff |q| == 2**frac_bits, and a power of two iff |q| is a power of two
    (positive or negative exponents both count: x0.5 is a shift as well).
    """
    q = torch.as_tensor(q_codes).to(torch.int32).reshape(-1)
    total = q.numel()
    a = q.abs()
    one_mag = 2**frac_bits if frac_bits >= 0 else 0
    is_zero = q == 0
    is_one = a == one_mag if one_mag > 0 else torch.zeros_like(is_zero)
    is_p2 = (a > 0) & ((a & (a - 1)) == 0) & ~is_one
    n_zero = int(is_zero.sum())
    n_one = int(is_one.sum())
    n_p2 = int(is_p2.sum())
    return ParamClassStats(
        zero=n_zero / total,
        one=n_one / total,
        pow2=n_p2 / total,
        other=(total - n_zero - n_one - n_p2) / total,
        total=total,
    )


def _per_channel_scale(w: torch.Tensor, axis: int) -> torch.Tensor:
    """Scale so the largest magnitude maps to the top code (2^6 * scale)."""
    reduce_dims = tuple(i for i in range(w.ndim) if i != axis)
    max_abs = torch.amax(w.abs(), dim=reduce_dims, keepdim=True)
    # Guard all-zero channels.
    max_abs = torch.where(max_abs == 0, torch.ones_like(max_abs), max_abs)
    return max_abs / POW2_MAX_MAG


def pow2_codes(w: torch.Tensor, *, channel_axis: int = -1):
    """Quantize ``w`` to the pow2 codebook.

    Returns:
      codes: uint8 tensor, same shape as w, values in [0, 15]:
             bit 3 = sign, bits 2:0 = magnitude index m (0 => zero).
      scale: float32 per-channel scale, broadcastable against w.
    """
    w = torch.as_tensor(w)
    axis = channel_axis % w.ndim
    scale = _per_channel_scale(w, axis).to(torch.float32)
    normalized = w.to(torch.float32) / scale  # in [-64, 64]
    mag = normalized.abs()
    # e = round(log2(mag)) clipped to [0, 6], as the reference rounds it:
    # the number of thresholds at or below mag.
    e = torch.bucketize(mag, _E_THRESHOLDS.to(mag.device), right=True)
    # Underflow to zero: values closer to 0 than to scale*2^0 in log space.
    is_zero = mag < _ZERO_THRESHOLD.to(mag.device)
    m = torch.where(is_zero, torch.zeros_like(e), e + 1)
    sign_bit = (normalized < 0).to(m.dtype) << 3
    codes = torch.where(m == 0, torch.zeros_like(m), sign_bit | m)
    return codes.to(torch.uint8), scale


def decode_pow2(codes: torch.Tensor, scale) -> torch.Tensor:
    """Decode 4-bit pow2 codes back to float32 values: ±2^(m-1) (exact
    powers of two, looked up by m; m == 0 is 0.0) times the per-channel
    scale."""
    codes = torch.as_tensor(codes)
    m = (codes & 0x7).to(torch.int64)
    sign = torch.where((codes & 0x8) != 0, -1.0, 1.0).to(torch.float32)
    mag = _POW2_MAGNITUDES.to(codes.device)[m]
    return sign * mag * scale


def project_pow2(w: torch.Tensor, *, channel_axis: int = -1) -> torch.Tensor:
    """Project weights onto the nearest pow2-codebook value (round trip)."""
    codes, scale = pow2_codes(w, channel_axis=channel_axis)
    return decode_pow2(codes, scale).to(w.dtype)


class _Pow2STE(torch.autograd.Function):
    """Pow2 projection forward, identity gradient backward."""

    @staticmethod
    def forward(ctx, w):
        return project_pow2(w)

    @staticmethod
    def backward(ctx, g):
        return g


def project_pow2_ste(w: torch.Tensor) -> torch.Tensor:
    """Pow2 projection with straight-through gradients (for pow2-aware
    fine-tuning, the analogue of the paper's post-quantization retrain)."""
    return _Pow2STE.apply(w)
