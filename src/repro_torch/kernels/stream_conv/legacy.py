"""The seed streaming-conv kernel, kept as a benchmark baseline — the
counterpart of ``repro.kernels.stream_conv.legacy``.

``stream_conv2d_seed`` is a bare VALID stride-1 conv with K*K per-tap
products against (C, N) tap matrices. Its kernel streams each image's rows
through a line buffer, as the TPU kernel did: a CTA walks a strip of
output rows in order with a ring of K + 1 input rows in shared memory
(``csrc/stream_conv_seed.cu``; design notes and bound there).
``seed_tile`` (plain Python, tested on the CPU) sizes the strip, the
register tile and the ring, and cuts a frame whose ring does not fit into
column strips, one launch each into one output tensor. It is superseded by the single-layer kernel
in ``conv.py`` and exists so that the seed-versus-fused comparison can be
made on the card; no plan calls it.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs the plain version, ``stream_conv2d_ref`` at VALID.
``LAUNCHES`` counts the launches; nothing else touches the count.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _nvcc
from repro_torch.kernels.backends import on_cuda, sm_count
from repro_torch.kernels.padding import round_up
from repro_torch.kernels.stream_conv.conv import SMEM_LIMIT, _check_cuda, _raise_on
from repro_torch.kernels.stream_conv.halo import column_strips
from repro_torch.kernels.stream_conv.ref import stream_conv2d_ref

MAX_GRID_Z = 65535  # images
# (TW output columns, TN channels) per thread, as instantiated in the
# source: the larger tile reads fewer shared-memory words per FMA, the
# smaller leaves more warps to hide latency where the work is small.
SEED_TILES = ((4, 8), (2, 4))
MAX_THREADS = 256  # SEED_MAX_THREADS in the source
MAX_STRIP = 32  # output rows per strip
# The warps a tile must give each SM before the larger tile is taken.
WARPS_PER_SM = 6

LAUNCHES = {"stream_conv2d_seed": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class _ScSeed(ctypes.Structure):
    _fields_ = [
        ("x", ctypes.c_void_p), ("w", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("x_img", ctypes.c_longlong), ("out_img", ctypes.c_longlong),
        ("x_rs", ctypes.c_int), ("out_rs", ctypes.c_int),
        ("batch", ctypes.c_int), ("h", ctypes.c_int), ("w_in", ctypes.c_int),
        ("c", ctypes.c_int), ("n", ctypes.c_int), ("k", ctypes.c_int),
        ("h_out", ctypes.c_int), ("w_out", ctypes.c_int),
        ("rows", ctypes.c_int), ("n_split", ctypes.c_int), ("cg", ctypes.c_int),
        ("ngc", ctypes.c_int), ("np", ctypes.c_int), ("cs", ctypes.c_int),
        ("rs", ctypes.c_int), ("xvec", ctypes.c_int), ("wvec", ctypes.c_int),
        ("tw", ctypes.c_int), ("tn", ctypes.c_int),
    ]


def ring_column_stride(c: int, cg: int, tasks: int, threads: int) -> int:
    """Words per ring column: C, or C + 1 .. C + 3 where that puts the
    columns the lanes of a warp read at one (tap, channel) in fewer
    shared-memory wavefronts. Task i of a row pass runs on thread i and
    reads column group i % cg; the sum over the first pass's warps of the
    most distinct addresses on one bank is what is minimised."""
    warps = [range(w0, min(w0 + 32, tasks)) for w0 in range(0, min(tasks, threads), 32)]

    def wavefronts(cs):
        total = 0
        for lanes in warps:
            banks = [0] * 32
            for g in {i % cg for i in lanes}:
                banks[g * cs % 32] += 1
            total += max(banks)
        return total

    return min(range(c, c + 4), key=lambda cs: (wavefronts(cs), cs))


@functools.lru_cache(maxsize=256)
def seed_tile(b: int, h: int, w: int, c: int, n: int, k: int, *, n_sms: int,
              resident) -> dict:
    """How the seed kernel covers a (b, h, w, c) frame, K x K taps and N
    channels on a card of ``n_sms`` SMs: the register tile (``tw`` columns
    x ``tn`` channels a thread), the threads of a CTA, ``rows`` output rows
    per strip over ``n_strips`` strips, N split over ``n_split`` CTAs of
    ``np`` staged channels, the ring's column and row strides (``cs``,
    ``rs``; K + 1 rows), the column ``strips`` (``halo.column_strips``:
    (first input column, end, first output column, end) per launch) and
    the CTA's shared-memory bytes.
    ``resident(tw, tn, c, threads, smem)`` gives the CTAs of that kind one
    SM holds (the wrapper asks the card's occupancy API).

    The tile is 4 x 8 where it still gives every SM ``WARPS_PER_SM`` warps
    at one row per CTA, else 2 x 4; the strip is as long as one wave of
    CTAs allows, up to 32 rows. N is split across CTAs only where a row's
    tasks exceed 256 threads or the weights do not fit; raises where even
    one channel group and the ring exceed 232,448 B. Where the whole
    frame's ring does not fit beside one channel group, the frame is cut
    into column strips, their width halved until one fits; raises where
    even a ring of one tile's columns does not (the weights of one
    channel group alone above the block)."""
    h_out, w_out = h - k + 1, w - k + 1
    for tw, tn in SEED_TILES:
        if tn == 8 and n <= 4:
            continue
        if b * h_out * -(-w_out // tw) * -(-n // tn) >= n_sms * WARPS_PER_SM * 32:
            break
    ng = -(-n // tn)

    def layout(ngc, cols):
        cg = -(-cols // tw)
        threads = min(MAX_THREADS, round_up(cg * ngc, 32))
        cs = ring_column_stride(c, cg, cg * ngc, threads)
        rs = round_up((cg * tw + k - 1) * cs, 4)
        np_ = ngc * tn
        return dict(cg=cg, ngc=ngc, np=np_, threads=threads, cs=cs, rs=rs,
                    smem=4 * (k * k * c * np_ + (k + 1) * rs))

    cols = w_out  # output columns per strip
    lay = layout(ng if -(-cols // tw) * ng <= MAX_THREADS else max(1, MAX_THREADS // -(-cols // tw)),
                 cols)
    while lay["smem"] > SMEM_LIMIT and lay["ngc"] > 1:
        lay = layout(-(-lay["ngc"] // 2), cols)
    while lay["smem"] > SMEM_LIMIT and cols > tw:
        cols = round_up(-(-cols // 2), tw)
        lay = layout(1, cols)
    if lay["smem"] > SMEM_LIMIT:
        raise ValueError(
            f"the seed kernel's ring of {k + 1} rows and weights of {lay['np']} channels "
            f"need {lay['smem']} B of shared memory, above the {SMEM_LIMIT} B a Hopper "
            "block may use"
        )
    strips = ((0, w, 0, w_out),) if cols >= w_out else column_strips(w, k, 1, 0, 0, cols)
    n_split = -(-ng // lay["ngc"])
    lay = layout(-(-ng // n_split), cols)  # the same split, channel groups evened out
    per_sm = max(1, resident(tw, tn, c, lay["threads"], lay["smem"]))
    units = b * h_out * n_split * len(strips)
    rows = min(MAX_STRIP, max(1, -(-units // (n_sms * per_sm))))
    n_strips = -(-h_out // rows)
    rows = -(-h_out // n_strips)
    return dict(tw=tw, tn=tn, rows=rows, n_strips=n_strips, n_split=n_split,
                ring_rows=k + 1, xvec=lay["cs"] == c and all(
                    (lo * c) % 4 == 0 and ((hi - lo) * c) % 4 == 0 for lo, hi, _, _ in strips)
                and (w * c) % 4 == 0, wvec=n % 4 == 0, strips=strips,
                resident=per_sm, ctas=b * n_strips * n_split * len(strips), **lay)


def _library() -> ctypes.CDLL:
    lib = _nvcc.load("stream_conv_seed")
    if not getattr(lib, "_seed_checked", False):
        lib.sc_seed_desc_bytes.argtypes, lib.sc_seed_desc_bytes.restype = [], ctypes.c_int
        lib.sc_seed_resident.argtypes = [ctypes.c_int] * 5
        lib.sc_seed_resident.restype = ctypes.c_int
        lib.sc_seed_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p]
        lib.sc_seed_launch.restype = ctypes.c_int
        if lib.sc_seed_desc_bytes() != ctypes.sizeof(_ScSeed):
            raise RuntimeError(
                f"_ScSeed is {ctypes.sizeof(_ScSeed)} B in Python but "
                f"{lib.sc_seed_desc_bytes()} B in the library: the layouts disagree"
            )
        lib._seed_checked = True
    return lib


@functools.lru_cache(maxsize=64)
def _resident(tw: int, tn: int, c: int, threads: int, smem: int) -> int:
    """CTAs of the (tw, tn) kernel for C channels that one SM of the
    current card holds (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    n = _library().sc_seed_resident(tw, tn, c, threads, smem)
    _raise_on(-n if n < 0 else 0, "stream_conv2d_seed occupancy query")
    return n


def stream_conv2d_seed_cuda(x: torch.Tensor, w_taps: torch.Tensor, *, k: int) -> torch.Tensor:
    """The seed conv on the card: x (B, H, W, C) and w_taps (K*K, C, N)
    float32, contiguous. Returns (B, H-K+1, W-K+1, N) float32."""
    b, h, wd, c = x.shape
    n = w_taps.shape[-1]
    h_out, w_out = h - k + 1, wd - k + 1
    _check_cuda("x", x)
    _check_cuda("w_taps", w_taps, (k * k, c, n))
    if b > MAX_GRID_Z:
        raise ValueError(f"batch {b} above the grid's {MAX_GRID_Z} images")
    # Raises where the ring and weights do not fit.
    t = seed_tile(b, h, wd, c, n, k, n_sms=sm_count(x.device), resident=_resident)
    out = torch.empty((b, h_out, w_out, n), device=x.device, dtype=torch.float32)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for in_lo, in_hi, o_lo, o_hi in t["strips"]:
            desc = _ScSeed(
                x=x.data_ptr() + 4 * in_lo * c, w=w_taps.data_ptr(),
                out=out.data_ptr() + 4 * o_lo * n, x_img=h * wd * c,
                out_img=h_out * w_out * n, x_rs=wd * c, out_rs=w_out * n, batch=b, h=h,
                w_in=in_hi - in_lo, c=c, n=n, k=k, h_out=h_out, w_out=o_hi - o_lo,
                rows=t["rows"], n_split=t["n_split"], cg=-(-(o_hi - o_lo) // t["tw"]),
                ngc=t["ngc"], np=t["np"], cs=t["cs"], rs=t["rs"],
                xvec=int(t["xvec"] and x.data_ptr() % 16 == 0),
                wvec=int(t["wvec"] and w_taps.data_ptr() % 16 == 0), tw=t["tw"], tn=t["tn"])
            err = lib.sc_seed_launch(ctypes.addressof(desc), t["smem"], t["threads"], stream)
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
