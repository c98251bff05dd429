"""ctypes wrapper of the hand-written Hopper selective scan
(``csrc/ssm_scan.cu``).

``ssm_scan_cuda`` replaces the reference's Pallas kernel
(``repro/kernels/ssm_scan/scan.py:ssm_scan_pallas``) and adds what the
reference's ``mamba_apply`` needs from the recurrence: an initial state
``h0`` and the final state ``h_last``. The design notes and bound are in
the source.

The wrapper checks device, dtype, shape and strides, allocates ``y`` and
``h_last`` with ``torch.empty``, launches on PyTorch's current stream and
raises if the launch is refused. x, B and C are read in their own dtype
(bfloat16 or float32, the same for all three) and may be strided views
with a unit last stride, as ``mamba_apply``'s slices of one projection
are; no cast or copy pass runs before the launch. ``LAUNCHES`` counts the
launches; nothing else touches the count. The plain version is
``ref.py``; ``ops.py`` picks between them by the device of the input.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _nvcc

MAX_BLOCK_D = 1024  # threads per block
MAX_N = 16  # SSM_MAX_N in the source: states a thread keeps in registers
MAX_GRID_Y = 65535  # batch rows
IN_DTYPES = {torch.bfloat16: 1, torch.float32: 0}

LAUNCHES = {"ssm_scan": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class _SsmScan(ctypes.Structure):
    _fields_ = [
        ("x", ctypes.c_void_p), ("dt", ctypes.c_void_p),
        ("b", ctypes.c_void_p), ("c", ctypes.c_void_p),
        ("a", ctypes.c_void_p), ("d_skip", ctypes.c_void_p),
        ("h0", ctypes.c_void_p), ("y", ctypes.c_void_p),
        ("h_last", ctypes.c_void_p),
        ("x_sb", ctypes.c_longlong), ("x_ss", ctypes.c_longlong),
        ("dt_sb", ctypes.c_longlong), ("dt_ss", ctypes.c_longlong),
        ("b_sb", ctypes.c_longlong), ("b_ss", ctypes.c_longlong),
        ("c_sb", ctypes.c_longlong), ("c_ss", ctypes.c_longlong),
        ("bz", ctypes.c_int), ("s", ctypes.c_int), ("d", ctypes.c_int),
        ("n", ctypes.c_int), ("block_d", ctypes.c_int), ("bf16", ctypes.c_int),
    ]


def _library() -> ctypes.CDLL:
    lib = _nvcc.load("ssm_scan")
    if not getattr(lib, "_ssm_checked", False):
        for fn in (lib.ssm_desc_bytes, lib.ssm_max_n):
            fn.argtypes, fn.restype = [], ctypes.c_int
        if lib.ssm_max_n() != MAX_N:
            raise RuntimeError(f"the library keeps {lib.ssm_max_n()} states, Python {MAX_N}")
        lib.ssm_scan_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.ssm_scan_launch.restype = ctypes.c_int
        if lib.ssm_desc_bytes() != ctypes.sizeof(_SsmScan):
            raise RuntimeError(
                f"_SsmScan is {ctypes.sizeof(_SsmScan)} B in Python but "
                f"{lib.ssm_desc_bytes()} B in the library: the layouts disagree"
            )
        lib._ssm_checked = True
    return lib


def _check(name: str, t: torch.Tensor, dtype, shape, *, contiguous=True) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(
            f"{name} must be {str(dtype).replace('torch.', '')}, got {t.dtype}"
        )
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if not contiguous and t.stride(-1) != 1:
        raise ValueError(f"{name} must have a unit stride on its last axis")


def ssm_scan_cuda(
    x: torch.Tensor,  # (Bz, S, D) bf16 or f32
    dt: torch.Tensor,  # (Bz, S, D) f32
    b: torch.Tensor,  # (Bz, S, N) x's dtype
    c: torch.Tensor,  # (Bz, S, N) x's dtype
    a: torch.Tensor,  # (D, N) f32
    d_skip: torch.Tensor,  # (D,) f32
    h0: torch.Tensor | None = None,  # (Bz, D, N) f32
    *,
    block_d: int = 256,
) -> tuple:
    """The selective scan on the card, one thread per channel, ``block_d``
    channels per block. Returns (y (Bz, S, D) f32, h_last (Bz, D, N)
    f32)."""
    bz, s, di = x.shape
    n = b.shape[-1]
    if x.dtype not in IN_DTYPES:
        raise ValueError(f"x must be bfloat16 or float32, got {x.dtype}")
    _check("x", x, x.dtype, (bz, s, di), contiguous=False)
    _check("dt", dt, torch.float32, (bz, s, di), contiguous=False)
    _check("b", b, x.dtype, (bz, s, n), contiguous=False)
    _check("c", c, x.dtype, (bz, s, n), contiguous=False)
    _check("a", a, torch.float32, (di, n))
    _check("d_skip", d_skip, torch.float32, (di,))
    if h0 is not None:
        _check("h0", h0, torch.float32, (bz, di, n))
    if not 1 <= block_d <= MAX_BLOCK_D:
        raise ValueError(f"block_d must be in [1, {MAX_BLOCK_D}], got {block_d}")
    if bz > MAX_GRID_Y:
        raise ValueError(f"batch {bz} above the grid's {MAX_GRID_Y} rows")
    if n > MAX_N:
        raise ValueError(f"the kernel keeps at most {MAX_N} states, got N={n}")
    y = torch.empty((bz, s, di), device=x.device, dtype=torch.float32)
    h_last = torch.empty((bz, di, n), device=x.device, dtype=torch.float32)
    desc = _SsmScan(
        x=x.data_ptr(), dt=dt.data_ptr(), b=b.data_ptr(), c=c.data_ptr(),
        a=a.data_ptr(), d_skip=d_skip.data_ptr(),
        h0=None if h0 is None else h0.data_ptr(), y=y.data_ptr(),
        h_last=h_last.data_ptr(),
        x_sb=x.stride(0), x_ss=x.stride(1), dt_sb=dt.stride(0), dt_ss=dt.stride(1),
        b_sb=b.stride(0), b_ss=b.stride(1), c_sb=c.stride(0), c_ss=c.stride(1),
        bz=bz, s=s, d=di, n=n, block_d=block_d, bf16=IN_DTYPES[x.dtype],
    )
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssm_scan_launch(ctypes.addressof(desc), stream)
    if err:
        raise RuntimeError(f"ssm_scan launch failed: CUDA error {err}")
    LAUNCHES["ssm_scan"] += 1
    return y, h_last
