"""Public wrapper for the pow2 matmul: weight quantization, validation and
dispatch on the device of the input.

A CUDA tensor goes to the hand-written kernel (``pow2.py``) and the call
raises if the kernel cannot take it; a CPU tensor goes to the plain
PyTorch version (``ref.py``). There is no other path and no fallback
between the two.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.quant.fixed_point import quantize_fixed
from repro_torch.core.quant.packing import pack_codes_u4
from repro_torch.core.quant.pow2 import pow2_codes
from repro_torch.kernels.pow2_matmul.pow2 import pow2_matmul_cuda
from repro_torch.kernels.pow2_matmul.ref import pow2_matmul_int_ref, pow2_matmul_ref


def quantize_weights(w: torch.Tensor):
    """(K, N) float weights -> (packed (K, ceil(N/2)) uint8, scale (N,) f32).

    Odd N is padded with a zero column so two codes always fill a byte;
    zero codes decode to 0.0, so the pad is exact. The returned ``scale``
    keeps the TRUE width N — it is the layer-width source of truth that
    lets ``pow2_matmul`` slice its output back to (M, N).
    """
    if w.ndim != 2:
        raise ValueError(f"expected (K, N) weights, got {tuple(w.shape)}")
    n = w.shape[1]
    if n % 2:
        w = F.pad(w, (0, 1))
    codes, scale = pow2_codes(w, channel_axis=1)  # scale (1, N_even)
    return pack_codes_u4(codes), scale.reshape(-1)[:n].contiguous()


def pow2_matmul(
    x: torch.Tensor,
    packed: torch.Tensor,
    scale: torch.Tensor,
    *,
    x_spec=None,  # FixedPointSpec of x's grid -> true-integer rendering
) -> torch.Tensor:
    """out[m, n] = sum_k x[m, k] * decode(codes[k, n]) * scale[n].

    The true layer width N is ``scale.shape[0]``; ``packed`` carries
    ceil(N/2) bytes (odd N is zero-column-padded by ``quantize_weights``).

    ``x_spec`` (a ``FixedPointSpec`` of at most 8 bits) switches to the
    true-integer rendering on every device: the codes decode to integer
    shift weights, the activations quantize onto ``x_spec``'s grid as int8
    codes (exact for on-grid x), and the product accumulates in integers
    before ``x_spec.scale * scale[n]`` folds in.
    """
    n = scale.shape[0]
    if packed.shape[1] != (n + 1) // 2:
        raise ValueError(
            f"packed width {packed.shape[1]} inconsistent with scale length "
            f"{n} (expected ceil(N/2) = {(n + 1) // 2} bytes)"
        )
    if x_spec is not None and x_spec.bits > 8:
        raise ValueError(
            f"the integer rendering takes int8 activation codes; x_spec has "
            f"{x_spec.bits} bits"
        )
    if x.device.type == "cpu":
        if x_spec is not None:
            return pow2_matmul_int_ref(x, packed, scale, x_spec=x_spec)
        return pow2_matmul_ref(x, packed, scale)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}; expected cuda or cpu")
    if x_spec is None:
        return pow2_matmul_cuda(
            x.contiguous(), packed.contiguous(), scale.contiguous()
        )
    # Quantize onto the activation grid before the launch, as the conv
    # wrappers quantize their frame: the kernel reads 1-byte codes.
    qx = quantize_fixed(x, x_spec).to(torch.int8) if x.is_floating_point() else x
    return pow2_matmul_cuda(
        qx.contiguous(), packed.contiguous(), scale.contiguous(),
        x_scale=x_spec.scale,
    )
