"""The seed streaming-conv kernel, kept as a benchmark baseline — the
counterpart of ``repro.kernels.stream_conv.legacy``.

``stream_conv2d_seed`` is a bare VALID stride-1 conv with K*K per-tap
products against (C, N) tap matrices, one output row per CTA
(``csrc/stream_conv_seed.cu``; design notes and bound there). It is
superseded by the single-layer kernel in ``conv.py`` and exists so that
the seed-versus-fused comparison can be made on the card; no plan calls
it.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs the plain version, ``stream_conv2d_ref`` at VALID.
``LAUNCHES`` counts the launches; nothing else touches the count.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _nvcc
from repro_torch.kernels.backends import on_cuda
from repro_torch.kernels.stream_conv.conv import SMEM_LIMIT, _check_cuda, _raise_on
from repro_torch.kernels.stream_conv.ref import stream_conv2d_ref

MAX_GRID_Y = 65535  # images

LAUNCHES = {"stream_conv2d_seed": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class _ScSeed(ctypes.Structure):
    _fields_ = [
        ("x", ctypes.c_void_p), ("w", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("batch", ctypes.c_int), ("h", ctypes.c_int), ("w_in", ctypes.c_int),
        ("c", ctypes.c_int), ("n", ctypes.c_int), ("k", ctypes.c_int),
        ("h_out", ctypes.c_int), ("w_out", ctypes.c_int),
    ]


def _library() -> ctypes.CDLL:
    lib = _nvcc.load("stream_conv_seed")
    if not getattr(lib, "_seed_checked", False):
        lib.sc_seed_desc_bytes.argtypes, lib.sc_seed_desc_bytes.restype = [], ctypes.c_int
        lib.sc_seed_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.sc_seed_launch.restype = ctypes.c_int
        if lib.sc_seed_desc_bytes() != ctypes.sizeof(_ScSeed):
            raise RuntimeError(
                f"_ScSeed is {ctypes.sizeof(_ScSeed)} B in Python but "
                f"{lib.sc_seed_desc_bytes()} B in the library: the layouts disagree"
            )
        lib._seed_checked = True
    return lib


def stream_conv2d_seed_cuda(x: torch.Tensor, w_taps: torch.Tensor, *, k: int) -> torch.Tensor:
    """The seed conv on the card: x (B, H, W, C) and w_taps (K*K, C, N)
    float32, contiguous. Returns (B, H-K+1, W-K+1, N) float32."""
    b, h, wd, c = x.shape
    n = w_taps.shape[-1]
    h_out, w_out = h - k + 1, wd - k + 1
    _check_cuda("x", x)
    _check_cuda("w_taps", w_taps, (k * k, c, n))
    if b > MAX_GRID_Y:
        raise ValueError(f"batch {b} above the grid's {MAX_GRID_Y} images")
    smem = k * wd * c * 4
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"the seed kernel's {k}-row window needs {smem} B of shared memory, "
            f"above the {SMEM_LIMIT} B a Hopper block may use"
        )
    out = torch.empty((b, h_out, w_out, n), device=x.device, dtype=torch.float32)
    desc = _ScSeed(x=x.data_ptr(), w=w_taps.data_ptr(), out=out.data_ptr(), batch=b, h=h,
                   w_in=wd, c=c, n=n, k=k, h_out=h_out, w_out=w_out)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sc_seed_launch(ctypes.addressof(desc), smem, stream)
    _raise_on(err, "stream_conv2d_seed")
    LAUNCHES["stream_conv2d_seed"] += 1
    return out


def stream_conv2d_seed(x: torch.Tensor, w_taps: torch.Tensor, *, k: int) -> torch.Tensor:
    """VALID stride-1 conv of x (B, H, W, C) with per-tap weights w_taps
    (K*K, C, N). Raises, as the reference does, on taps inconsistent with
    ``k`` and C and on a frame smaller than the kernel."""
    b, h, wd, c = x.shape
    kk, c2, n = w_taps.shape
    if kk != k * k or c2 != c:
        raise ValueError(f"w_taps {tuple(w_taps.shape)} inconsistent with k={k}, C={c}")
    if h - k + 1 <= 0 or wd - k + 1 <= 0:
        raise ValueError(f"image {h}x{wd} too small for k={k}")
    if on_cuda(x):
        return stream_conv2d_seed_cuda(x, w_taps, k=k)
    return stream_conv2d_ref(x, w_taps.reshape(k, k, c, n))
