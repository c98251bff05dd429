"""Device policy shared by the port's entry points.

The reference selects a kernel path with a ``backend=`` enum and, off the
TPU, silently lowers its ``pallas`` backend through an XLA rendering of the
same algorithm. The port has no such fallback. It has two devices:

  ``cuda``  the default. Kernel wrappers launch the hand-written Hopper
            kernels on CUDA tensors. With no card this raises.
  ``cpu``   only when the caller asks for it. Kernel wrappers run their
            plain PyTorch versions (each kernel's ``ref.py``) on CPU
            tensors; this is what the CPU tests use.

Entry points that create tensors (``compile_dhm``, ``Engine``,
``params_from_numpy``, ``transformer.init_params``,
``lm_params_from_numpy``) take ``device=`` and resolve it here; the
kernel wrappers follow the device of the tensor they are given
(``on_cuda``).
"""
from __future__ import annotations

import contextlib
import functools

import torch

VALID_DEVICES = ("cuda", "cpu")

DEFAULT_DEVICE = "cuda"


def on_cuda(t: torch.Tensor) -> bool:
    """The kernel wrappers' dispatch: True for a CUDA tensor (launch the
    kernel), False for a CPU tensor (run the plain version); a tensor on
    any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}; expected cuda or cpu")


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


_CONSTANTS_ON: dict = {}  # (key, device) -> a host constant there


def constant_on(key, device, make) -> torch.Tensor:
    """The host constant ``make()`` (a tensor) on ``device``, copied there
    once and kept under ``key``: a step captured in a CUDA graph may copy
    nothing from the host, and its eager warm-up makes the copy first."""
    t = _CONSTANTS_ON.get((key, device))
    if t is None:
        t = _CONSTANTS_ON[key, device] = make().to(device)
    return t


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SMs of the card ``device`` names, for the wrappers that size a
    grid to one wave."""
    dev = torch.device(device)
    return _sm_count(torch.cuda.current_device() if dev.index is None else dev.index)


_BACKWARD_ON_CUDNN = False


@contextlib.contextmanager
def backward_numerics(t: torch.Tensor):
    """IEEE fp32 and deterministic convolutions for a recomputed backward
    on the card (the stream-conv and scan autograd Functions): TF32 off
    for matmuls, and PyTorch's own CUDA convolution (im2col and cuBLAS
    GEMMs) in place of cuDNN. On an H100, under ``deterministic=True,
    allow_tf32=False``, cuDNN picks for lenet5's first layer at B=16 an
    algorithm whose gradients sit 5.8e-4 (relative L2) from a float64
    composition, where this path sits at 4.5e-7 (``chip_smoke.py`` phase
    5g prints both); it costs a slower backward. Inside
    :func:`cudnn_backward` the convolutions run on cuDNN instead, with
    the same flags. On the CPU nothing changes."""
    if not t.is_cuda:
        yield
        return
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=_BACKWARD_ON_CUDNN, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@contextlib.contextmanager
def cudnn_backward():
    """Within the block, :func:`backward_numerics` runs the recomputed
    backward's convolutions on cuDNN (``deterministic=True``, TF32 off),
    for comparing the two. The switch is process-wide, not per thread:
    autograd runs a backward on its own device thread. A CUDA graph
    records the numerics in force at its capture, so capture none inside
    the block."""
    global _BACKWARD_ON_CUDNN
    prev, _BACKWARD_ON_CUDNN = _BACKWARD_ON_CUDNN, True
    try:
        yield
    finally:
        _BACKWARD_ON_CUDNN = prev
