from repro_torch.kernels.pow2_matmul.ops import pow2_matmul, quantize_weights
from repro_torch.kernels.pow2_matmul.ref import pow2_matmul_int_ref, pow2_matmul_ref

__all__ = ["pow2_matmul", "quantize_weights", "pow2_matmul_ref", "pow2_matmul_int_ref"]
