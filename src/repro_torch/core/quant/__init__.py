"""Quantization of the port (fixed-point Q-formats)."""
