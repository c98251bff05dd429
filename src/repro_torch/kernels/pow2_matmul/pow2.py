"""ctypes wrapper of the hand-written Hopper pow2 matmul
(``csrc/pow2_matmul.cu``).

``pow2_matmul_cuda`` replaces the reference's Pallas kernel
(``repro/kernels/pow2_matmul/pow2.py:pow2_matmul_pallas``) and adds the
integer rendering that the reference computes only on its CPU path
(``ref.py:pow2_matmul_int_ref``). The design notes and bound are in the
source. ``p2_plan`` (plain Python, tested on the CPU) picks how many CTAs
of a thread-block cluster split each output tile's K range.

The wrapper checks device, dtype, shape and contiguity, allocates its
output with ``torch.empty``, launches on PyTorch's current stream and
raises if the launch is refused. ``LAUNCHES`` counts the launches of each
mode; besides the wrapper, only a CUDA graph of it touches the counts
(``probe.uncount`` at its capture, ``probe.replayed`` at each replay).
Each launch is also logged to the calling thread's ``probe`` log, where
one is open. The plain versions are in
``ref.py``; ``ops.py`` picks between them by the device of the input.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _nvcc, probe
from repro_torch.kernels.backends import sm_count

BLOCK_M = 16  # P2_BM in the source: output rows per tile
BLOCK_N = 64  # P2_BN: output columns per tile
BLOCK_K = 32  # P2_BK: K rows per slice
SPLITS = (8, 4, 2, 1)  # the portable cluster sizes, largest first
CTAS_PER_SM = 2  # one wave: two CTAs on every SM
MAX_GRID_Z = 65535  # row tiles

LAUNCHES = probe.counted({"pow2_matmul": 0, "pow2_matmul_int": 0})


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class _P2Matmul(ctypes.Structure):
    _fields_ = [
        ("x", ctypes.c_void_p), ("packed", ctypes.c_void_p),
        ("scale", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("m", ctypes.c_int), ("k", ctypes.c_int), ("n", ctypes.c_int),
        ("nb", ctypes.c_int), ("int_mode", ctypes.c_int),
        ("x_scale", ctypes.c_float), ("split", ctypes.c_int),
        ("slices", ctypes.c_int), ("xvec", ctypes.c_int),
    ]


@functools.lru_cache(maxsize=256)
def p2_plan(m: int, k: int, n: int, n_sms: int) -> dict:
    """How the kernel splits (M, K) x (K, N) on a card of ``n_sms`` SMs:
    output tiles of BLOCK_M x BLOCK_N, K in slices of BLOCK_K, and
    ``split`` CTAs of one cluster per tile, each reducing a contiguous run
    of slices (``k_ranges``: rank r takes slices r * slices // split up to
    the next rank's, as the kernel computes them). The split is the largest
    portable cluster size that keeps the CTAs within one wave (tiles x
    split <= CTAS_PER_SM x n_sms) and gives every CTA at least two slices,
    so that the copy of its next slice overlaps the current one; 1 where K
    is small or the tiles fill the card alone. ``recv_bytes`` is the
    dynamic shared memory a launch requests, rank 0's receive slots as the
    source sizes them (one 4-byte tile per peer)."""
    slices = -(-k // BLOCK_K)
    tiles = -(-m // BLOCK_M) * -(-n // BLOCK_N)
    wave = CTAS_PER_SM * n_sms
    split = next(s for s in SPLITS if s == 1 or (tiles * s <= wave and 2 * s <= slices))
    bounds = [r * slices // split for r in range(split + 1)]
    k_ranges = [(bounds[r] * BLOCK_K, min(k, bounds[r + 1] * BLOCK_K)) for r in range(split)]
    return dict(bm=BLOCK_M, bn=BLOCK_N, bk=BLOCK_K, split=split, slices=slices, tiles=tiles,
                ctas=tiles * split, k_ranges=k_ranges,
                recv_bytes=(split - 1) * BLOCK_M * BLOCK_N * 4)


def _library() -> ctypes.CDLL:
    lib = _nvcc.load("pow2_matmul")
    if not getattr(lib, "_p2_checked", False):
        lib.p2_desc_bytes.argtypes, lib.p2_desc_bytes.restype = [], ctypes.c_int
        lib.p2_matmul_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.p2_matmul_launch.restype = ctypes.c_int
        if lib.p2_desc_bytes() != ctypes.sizeof(_P2Matmul):
            raise RuntimeError(
                f"_P2Matmul is {ctypes.sizeof(_P2Matmul)} B in Python but "
                f"{lib.p2_desc_bytes()} B in the library: the layouts disagree"
            )
        lib._p2_checked = True
    return lib


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(
            f"{name} must be {str(dtype).replace('torch.', '')}, got {t.dtype}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")


def pow2_matmul_cuda(
    x: torch.Tensor,  # (M, K) float32, or int8 codes with x_scale
    packed: torch.Tensor,  # (K, ceil(N/2)) uint8
    scale: torch.Tensor,  # (N,) float32
    *,
    x_scale: float | None = None,
) -> torch.Tensor:
    """``x @ decode(codes) * scale`` on the card. With ``x_scale`` (the
    activation grid's pow2 scale) ``x`` must be int8 codes on that grid
    and the product runs in integers (int32 accumulation). Returns
    (M, N) float32."""
    if x.ndim != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    m, k = x.shape
    n = scale.shape[0]
    nb = (n + 1) // 2
    int_mode = x_scale is not None
    _check("x", x, torch.int8 if int_mode else torch.float32, (m, k))
    _check("packed", packed, torch.uint8, (k, nb))
    _check("scale", scale, torch.float32, (n,))
    if -(-m // BLOCK_M) > MAX_GRID_Z:
        raise ValueError(f"{m} rows above the grid's {MAX_GRID_Z * BLOCK_M}")
    plan = p2_plan(m, k, n, sm_count(x.device))
    out = torch.empty((m, n), device=x.device, dtype=torch.float32)
    desc = _P2Matmul(
        x=x.data_ptr(), packed=packed.data_ptr(), scale=scale.data_ptr(),
        out=out.data_ptr(), m=m, k=k, n=n, nb=nb, int_mode=int(int_mode),
        x_scale=float(x_scale) if int_mode else 0.0, split=plan["split"],
        slices=plan["slices"],
        xvec=int(not int_mode and k % 4 == 0 and x.data_ptr() % 16 == 0),
    )
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.p2_matmul_launch(ctypes.addressof(desc), stream)
    if err:
        raise RuntimeError(f"pow2_matmul launch failed: CUDA error {err}")
    name = "pow2_matmul_int" if int_mode else "pow2_matmul"
    LAUNCHES[name] += 1
    probe.launched(name, plan["recv_bytes"], stream)
    return out
