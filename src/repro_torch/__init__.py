"""PyTorch and CUDA port of the ``repro`` package for NVIDIA Hopper.

Modules sit at the same relative paths, with the same public names, as
their counterparts in ``repro``; the streaming conv kernels are
hand-written CUDA for ``sm_90a`` (``csrc/``). The package imports
``torch`` and never ``jax`` or ``repro``. Entry points run on the card
unless the caller passes ``device="cpu"`` (see ``kernels/backends.py``).
"""
