"""Quantization of the port: fixed-point Q-formats, the pow2 codebook and
4-bit code packing."""
