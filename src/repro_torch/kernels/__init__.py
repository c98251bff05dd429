"""Kernel wrappers of the port: device policy, padding helpers, and the
streaming conv kernels."""
