"""Packing of 4-bit pow2 codes, two per byte.

The counterpart of ``repro.core.quant.packing``: uint8 bytes holding two
4-bit codes each along the *last* axis (even index in the low nibble),
which the ``pow2_matmul`` kernel streams as its weights. The last axis
must be even.
"""
from __future__ import annotations

import torch


def pack_codes_u4(codes: torch.Tensor) -> torch.Tensor:
    """Pack uint8 codes in [0,16) two-per-byte along the last axis."""
    codes = torch.as_tensor(codes).to(torch.uint8)
    if codes.shape[-1] % 2 != 0:
        raise ValueError(f"last axis must be even, got {tuple(codes.shape)}")
    lo = codes[..., 0::2]
    hi = codes[..., 1::2]
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_codes_u4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_codes_u4`."""
    packed = torch.as_tensor(packed).to(torch.uint8)
    lo = packed & 0x0F
    hi = packed >> 4
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2)
