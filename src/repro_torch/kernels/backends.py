"""Device policy shared by the port's entry points.

The reference selects a kernel path with a ``backend=`` enum and, off the
TPU, silently lowers its ``pallas`` backend through an XLA rendering of the
same algorithm. The port has no such fallback. It has two devices:

  ``cuda``  the default. Kernel wrappers launch the hand-written Hopper
            kernels on CUDA tensors. With no card this raises.
  ``cpu``   only when the caller asks for it. Kernel wrappers run their
            plain PyTorch versions (``stream_conv/ref.py``) on CPU tensors;
            this is what the CPU tests use.

Entry points that create tensors (``compile_dhm``, ``Engine``,
``params_from_numpy``) take ``device=`` and resolve it here; the kernel
wrappers follow the device of the tensor they are given.
"""
from __future__ import annotations

import torch

VALID_DEVICES = ("cuda", "cpu")

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """The ``torch.device`` an entry point runs on: ``cuda`` unless the
    caller passes ``device="cpu"``. Raises when the card is asked for and
    absent, and on any other device type — never carries on quietly on
    the CPU."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type not in VALID_DEVICES:
        raise ValueError(
            f"unknown device {device!r}; expected one of {VALID_DEVICES}"
        )
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return dev
