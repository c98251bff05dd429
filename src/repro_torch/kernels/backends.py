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


@contextlib.contextmanager
def cudnn_backward():
    """cuDNN on (``deterministic=True``, ``benchmark=False``), TF32 off
    for convolutions and matmuls, within the block: the numerics of the
    yardstick ``chip_smoke.py`` times and holds against float64 beside the
    port's backward kernels, autograd of ``ref.py``'s composition through
    cuDNN. The port never runs under it: its stream-conv gradient is the
    hand-written kernels (``stream_conv/ops.py`` ``_GroupGrad``). On an
    H100, for lenet5's first layer at B=16, cuDNN's deterministic
    algorithm sits 5.8e-4 (relative L2) from a float64 composition."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
