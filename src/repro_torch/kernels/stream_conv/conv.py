"""ctypes wrappers of the hand-written Hopper streaming conv kernels
(``csrc/stream_conv.cu``).

``stream_conv_fused_cuda`` replaces the reference's single-layer Pallas
kernel (``repro/kernels/stream_conv/conv.py:stream_conv_fused_pallas``):
one CTA per (row block, image) over a host-SAME-padded frame, fused
bias -> act -> pool -> quant epilogue; a frame too wide for one block
runs as column strips (the reference's ``block_w``), one launch each into
one output tensor, and a layer whose weight stages do not fit as slices
of its channels (``fused_plan``). An int8 layer whose channels are whole
64-byte K steps takes the kernel's wgmma path instead (``fused_path``):
one launch, its weights streamed in K steps (``kmajor_weights``) past a
resident slab that serves every output channel (``wgmma_geometry``).
``stream_conv_pyramid_cuda``
replaces the cross-layer pyramid (``stream_conv_pyramid_pallas``): one CTA
per (row block, image) streams a whole fusion group with every
inter-layer slab in shared memory. The fp32 kernels run each layer as a
register-tiled implicit GEMM over the slab (weights staged in shared
memory); this module sizes their shared-memory layout
(``pyramid_layout``, ``fused_geometry``). Each has an int8 variant
(``int8_scales``): int8 frame and weight codes, int32 accumulation on
the s8 tensor cores, the exact pow2 dequantization, and int8 codes
between pyramid layers; ``int8_layout`` lays out its block, with the
kernel's own address arithmetic beside it (``int8_taps``,
``int8_row_base``, ``int8_w_offset``). The design notes and bounds of
all four kernels are in the source. The
kernels take any pool window: 2 and 3 compiled, every other one read at
run time. ``card_groups`` splits the reference's fusion groups into
groups the pyramid kernel can take (at most ``MAX_PYRAMID_LAYERS``
layers within ``SMEM_LIMIT``).

Each wrapper checks device, dtype, shape and contiguity, allocates its
output with ``torch.empty``, launches on PyTorch's current stream and
raises if the launch is refused. ``LAUNCHES`` counts the launches of each
kernel; besides the wrappers, only a CUDA graph of them touches the
counts (``probe.uncount`` at its capture, ``probe.replayed`` at each
replay). Each launch is also logged to the calling thread's ``probe``
log, where one is open. The plain versions of both
kernels are in ``ref.py``; ``ops.py`` picks between them by the device of
the input tensor.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools
import math
from typing import Optional

import torch

from repro_torch.kernels import _nvcc, probe
from repro_torch.kernels.backends import sm_count
from repro_torch.kernels.padding import round_up
from repro_torch.kernels.stream_conv.epilogue import (
    normalize_pool,
    pool_out_dim,
    stream_quant_spec,
)
from repro_torch.kernels.stream_conv.halo import column_strips, group_geometry

# Shared memory one block may use on Hopper (227 KB of the SM's 256 KB).
SMEM_LIMIT = 232_448
MAX_PYRAMID_LAYERS = 4  # SC_MAX_LAYERS in the source
THREADS = 256  # SC_THREADS in the source
K_STAGE = 64  # SC_KC in the source: weight rows per shared-memory stage
ACT_CODES = {"none": 0, "relu": 1, "tanh": 2}

FORWARD_KERNELS = ("stream_conv_fused", "stream_conv_pyramid", "stream_conv_fused_int8",
                   "stream_conv_pyramid_int8")
# The gradient's kernels (csrc/stream_conv_bwd.cu), in launch order.
BACKWARD_KERNELS = ("stream_conv_bwd_recompute", "stream_conv_bwd_dx", "stream_conv_bwd_dw",
                    "stream_conv_bwd_reduce")
LAUNCHES = probe.counted({name: 0 for name in FORWARD_KERNELS + BACKWARD_KERNELS})
# The single-layer int8 kernel's launches by main loop (``fused_path``),
# as its wrapper makes them: eager calls and the calls a graph's capture
# records. A replay runs no wrapper; its capture record's launch table
# (``CardLaunch.path``) names the paths of what it launches.
PATH_LAUNCHES = {"wgmma": 0, "mma_sync": 0}
# The int8 kernels' MMA (mma.sync m16n8k32 s8): K bytes per step, and the
# staged weight rows' alignment (whole 128-byte groups of eight 16-byte
# chunks, which the staging swizzles).
MMA_K = 32
W_ROW_ALIGN = 128
# n8 tiles per warp task compiled for each pool window of the int8 kernels
# (sc_gemm_i8_pick in the source); every other window takes one.
I8_TILES_N = {1: (4, 2, 1), 2: (4, 2, 1), 3: (2, 1)}


def reset_launch_counts() -> None:
    for table in (LAUNCHES, PATH_LAUNCHES):
        for name in table:
            table[name] = 0


class _ScLayer(ctypes.Structure):
    _fields_ = [
        ("w", ctypes.c_void_p), ("b", ctypes.c_void_p),
        ("k", ctypes.c_int), ("stride", ctypes.c_int), ("act", ctypes.c_int),
        ("pw", ctypes.c_int), ("ps", ctypes.c_int), ("qbits", ctypes.c_int),
        ("qscale", ctypes.c_float), ("qmin", ctypes.c_float),
        ("qmax", ctypes.c_float),
        ("in_rows", ctypes.c_int), ("in_cols", ctypes.c_int),
        ("in_ch", ctypes.c_int), ("pad_l", ctypes.c_int),
        ("pad_r", ctypes.c_int),
        ("out_cols", ctypes.c_int), ("n_out", ctypes.c_int),
        ("in_mult", ctypes.c_int), ("in_off", ctypes.c_int),
        ("in_slab_rows", ctypes.c_int), ("out_slab_rows", ctypes.c_int),
        ("deq", ctypes.c_float),
        ("cs", ctypes.c_int), ("rs", ctypes.c_int), ("tn", ctypes.c_int),
        ("np", ctypes.c_int), ("wvec", ctypes.c_int),
        ("q", ctypes.c_int), ("cpad", ctypes.c_int), ("kpad", ctypes.c_int),
        ("wrow", ctypes.c_int), ("swz", ctypes.c_int),
    ]


class _ScPyramid(ctypes.Structure):
    _fields_ = [
        ("x", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("batch", ctypes.c_int), ("n_layers", ctypes.c_int),
        ("n_rb", ctypes.c_int), ("block_rows", ctypes.c_int),
        ("out_rows", ctypes.c_int),
        ("buf0_elems", ctypes.c_int),
        ("tap_off", ctypes.c_int), ("wst_off", ctypes.c_int),
        ("wst_elems", ctypes.c_int),
        ("L", _ScLayer * MAX_PYRAMID_LAYERS),
    ]


class _ScFused(ctypes.Structure):
    _fields_ = [
        ("x", ctypes.c_void_p), ("w", ctypes.c_void_p),
        ("b", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("x_img", ctypes.c_longlong), ("out_img", ctypes.c_longlong),
        ("x_rs", ctypes.c_int), ("out_rs", ctypes.c_int), ("out_cs", ctypes.c_int),
        ("w_ld", ctypes.c_int),
        ("batch", ctypes.c_int), ("h", ctypes.c_int), ("w_in", ctypes.c_int),
        ("c", ctypes.c_int), ("n", ctypes.c_int), ("k", ctypes.c_int),
        ("stride", ctypes.c_int), ("act", ctypes.c_int), ("pw", ctypes.c_int),
        ("ps", ctypes.c_int), ("qbits", ctypes.c_int),
        ("qscale", ctypes.c_float), ("qmin", ctypes.c_float),
        ("qmax", ctypes.c_float),
        ("h_keep", ctypes.c_int), ("w_keep", ctypes.c_int), ("r", ctypes.c_int),
        ("r_o", ctypes.c_int), ("in_rows_blk", ctypes.c_int),
        ("n_rb", ctypes.c_int), ("deq", ctypes.c_float),
        ("cs", ctypes.c_int), ("rs", ctypes.c_int), ("tn", ctypes.c_int),
        ("np", ctypes.c_int), ("wvec", ctypes.c_int), ("tap_off", ctypes.c_int),
        ("wst_off", ctypes.c_int), ("wst_elems", ctypes.c_int),
        ("threads", ctypes.c_int),
        ("q", ctypes.c_int), ("cpad", ctypes.c_int), ("kpad", ctypes.c_int),
        ("wrow", ctypes.c_int), ("swz", ctypes.c_int),
        ("wg", ctypes.c_int), ("stages", ctypes.c_int), ("grid", ctypes.c_int),
    ]


def _library() -> ctypes.CDLL:
    lib = _nvcc.load("stream_conv")
    if not getattr(lib, "_sc_checked", False):
        for fn in (lib.sc_pyramid_desc_bytes, lib.sc_fused_desc_bytes):
            fn.argtypes, fn.restype = [], ctypes.c_int
        lib.sc_ctas_per_sm.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.sc_ctas_per_sm.restype = ctypes.c_int
        for fn in (lib.sc_pyramid_launch, lib.sc_fused_launch,
                   lib.sc_pyramid_i8_launch, lib.sc_fused_i8_launch):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for fn, struct in (
            (lib.sc_pyramid_desc_bytes, _ScPyramid),
            (lib.sc_fused_desc_bytes, _ScFused),
        ):
            if fn() != ctypes.sizeof(struct):
                raise RuntimeError(
                    f"{struct.__name__} is {ctypes.sizeof(struct)} B in Python "
                    f"but {fn()} B in the library: the layouts disagree"
                )
        lib._sc_checked = True
    return lib


def _quant_fields(act_bits) -> dict:
    if act_bits is None:
        return dict(qbits=0, qscale=1.0, qmin=0.0, qmax=0.0)
    spec = stream_quant_spec(act_bits)
    return dict(
        qbits=act_bits, qscale=spec.scale, qmin=float(spec.qmin),
        qmax=float(spec.qmax),
    )


def _check_cuda(name: str, t: torch.Tensor, shape=None,
                dtype=torch.float32) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    _check_operand(name, t, shape, dtype)


def _check_operand(name: str, t: torch.Tensor, shape=None,
                   dtype=torch.float32) -> None:
    """dtype, contiguity and shape, the same on every device."""
    if t.dtype != dtype:
        raise ValueError(
            f"{name} must be {str(dtype).replace('torch.', '')}, got {t.dtype}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def ctas_per_sm(kernel: str, smem_bytes: int, threads: int = THREADS) -> int:
    """CTAs of one of the four kernels (named as in ``LAUNCHES``; the
    single-layer int8 kernel's wgmma path as
    ``"stream_conv_fused_int8_wgmma"``) that fit on one SM of the current
    card at ``threads`` per CTA and ``smem_bytes`` of dynamic shared
    memory (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    which = {"stream_conv_pyramid": 0, "stream_conv_fused": 1,
             "stream_conv_pyramid_int8": 2, "stream_conv_fused_int8": 3,
             "stream_conv_fused_int8_wgmma": 4}[kernel]
    n = _library().sc_ctas_per_sm(which, smem_bytes, threads)
    _raise_on(-n if n < 0 else 0, f"{kernel} occupancy query")
    return n


# ---------------------------------------------------------------------------
# The fp32 kernels' implicit-GEMM layout (sc_gemm in the source).


def column_stride(c: int) -> int:
    """Words per slab column of the fp32 kernels: C for odd C, C + 1 for
    even C, so neighbouring windows of a warp fall in different banks."""
    return c if c % 2 else c + 1


def _windows_per_thread(pw: int) -> int:
    return 4 if pw in (0, 1) else 1


@functools.lru_cache(maxsize=1024)
def row_stride(cols: int, cs: int, step: int, out_cols: int, n_windows: int) -> int:
    """Words per slab row of the fp32 kernels: ``cols * cs`` plus the pad
    (0-31 words) that puts the 16 windows a warp gathers at one tap in the
    fewest shared-memory wavefronts (the most lanes on one of the 32
    banks, summed over the warps' window sets). ``step`` is the window
    pitch in conv-input pixels (pool stride times conv stride); windows
    run row-major over ``out_cols`` columns."""
    base = cols * cs
    bases = [((w // out_cols) * step, (w % out_cols) * step * cs)
             for w in range(n_windows)]
    sets = [bases[w0:w0 + 16] for w0 in range(0, n_windows, 16)]

    def wavefronts(rs):
        total = 0
        for group in sets:
            banks = [0] * 32
            for r, c in group:
                banks[(r * rs + c) % 32] += 1
            total += max(banks)
        return total

    return base + min(range(32), key=lambda pad: (wavefronts(base + pad), pad))


def _warp_tasks(pw: int, n_out: int, n_windows: int, tn: int) -> int:
    """Warp tasks (16 windows x 2 channel groups of ``tn``) of one layer
    in one CTA; ``n_windows`` is the pooled outputs (conv positions
    without a pool) the CTA computes."""
    groups = -(-n_out // tn)
    return -(-n_windows // (16 * _windows_per_thread(pw))) * ((groups + 1) // 2)


def tile_n(pw: int, n_out: int, n_windows: int) -> int:
    """Output channels per thread of a pyramid layer (TN in the source):
    8, unless the pool window is 3 (register pressure) or above (the
    run-time window path, compiled at 4), or the layer has too few warp
    tasks at 8 to occupy the CTA's eight warps, then 4."""
    if pw >= 3 or _warp_tasks(pw, n_out, n_windows, 8) < THREADS // 32:
        return 4
    return 8


def fused_tile(pw: int, n_out: int, n_windows: int) -> tuple:
    """(TN, threads per CTA) of the single-layer kernel, whose CTA size is
    free: TN = 8 with one warp per task (four to eight warps) where the
    layer has four tasks at 8, else TN = 4 (always at pool window 3 and
    above) and up to eight warps. A larger tile per thread reads fewer
    shared-memory words per FMA; smaller CTAs keep 16 warps per SM."""
    if pw < 3:
        tasks = _warp_tasks(pw, n_out, n_windows, 8)
        if tasks >= 4:
            return 8, 32 * min(THREADS // 32, tasks)
    return 4, 32 * min(THREADS // 32, _warp_tasks(pw, n_out, n_windows, 4))


def _taps_words(k: int, c: int) -> int:
    return round_up(k * k * c, 4)


def _stage_words(n_out: int, tn: int) -> tuple:
    """(staged weight row stride, floats of one stage)."""
    np_ = round_up(n_out, tn)
    return np_, K_STAGE * np_


# ---------------------------------------------------------------------------
# The int8 kernels' implicit-GEMM layout (sc_gemm_i8 in the source): one
# s8 tensor-core MMA (m16n8k32) over int8 slabs in shared memory. The
# functions below are the kernel's own address arithmetic, so the layout
# (and its bank conflicts) can be checked on the CPU.


@dataclasses.dataclass(frozen=True)
class Int8Slab:
    """One layer of an int8 block, as the block sees it: an input slab of
    ``rows`` x ``cols`` pixels of ``c`` channels (the rows and the padded
    columns the block stores), a ``k`` x ``k`` conv of ``stride``, a pool
    window ``pw`` (0: none) of stride ``ps``, ``n`` output channels and at
    most ``n_wr`` x ``n_wc`` outputs (pooled windows) per block."""

    rows: int
    cols: int
    c: int
    k: int
    stride: int
    pw: int
    ps: int
    n: int
    n_wr: int
    n_wc: int


@dataclasses.dataclass(frozen=True)
class Int8Layer:
    """One layer's int8 layout. The slab holds ``cpad`` channels a column
    (C where C % 16 == 0, whose 16-byte runs ``ldmatrix`` reads; else C
    rounded up to 4, read as 32-bit words), columns ``cs`` bytes apart in
    ``stride`` phases of ``q`` columns (input column x at ``(x % stride) *
    q + x // stride``), rows ``rs`` bytes apart, ``rows`` of them. K is
    ``k * k * cpad`` rounded up to the MMA's 32 (``kpad``); a warp task
    takes ``nt`` n8 tiles; the weights stage as ``n_pad`` rows (N rounded
    up to ``8 * nt``) of ``w_row`` bytes; ``swz`` puts rows 4-7 and 12-15
    of a pool-window-2 tile at pool position ``p ^ 1``."""

    cpad: int
    cs: int
    q: int
    rs: int
    rows: int
    kdim: int
    kpad: int
    nt: int
    n_pad: int
    w_row: int
    swz: int

    @property
    def ldm(self) -> bool:
        return self.cpad % 16 == 0

    @property
    def grain(self) -> int:
        """Bytes of K per tap-table entry."""
        return 16 if self.ldm else 4

    @property
    def slab_bytes(self) -> int:
        return self.rows * self.rs

    @property
    def w_bytes(self) -> int:
        return self.n_pad * self.w_row


@dataclasses.dataclass(frozen=True)
class Int8Layout:
    """An int8 block's shared memory, in bytes: two ping-pong slab
    buffers (``buf0``, ``buf1``; one layer uses ``buf0``), the tap table at
    ``tap_off`` and the staged weights of one layer at ``wst_off``."""

    layers: tuple
    buf0: int
    buf1: int
    tap_off: int
    wst_off: int
    smem: int


def int8_tiles(pw: int) -> tuple:
    """(A tiles of a warp task, outputs of a warp task) of a pool window:
    no pool, 4 tiles of 16 outputs; windows 2 and 3, one tile per
    position of the same 16 windows; any other, one tile at a time."""
    pw = pw or 1
    if pw == 1:
        return 4, 64
    return (pw * pw if pw in (2, 3) else 1), 16


def int8_slab_offset(lay: Int8Layer, row: int, x: int, c: int, stride: int) -> int:
    """Slab byte of input row ``row``, column ``x``, channel ``c``."""
    return row * lay.rs + ((x % stride) * lay.q + x // stride) * lay.cs + c


def int8_taps(lay: Int8Layer, k: int, stride: int) -> tuple:
    """The tap table: the slab offset of each K granule (``grain``
    bytes), K in (ki, kj, c) order; granules past ``kdim`` read 0."""
    out = []
    for i in range(lay.kpad // lay.grain):
        kk = i * lay.grain
        if kk >= lay.kdim:
            out.append(0)
            continue
        tap, c = divmod(kk, lay.cpad)
        ki, kj = divmod(tap, k)
        out.append(int8_slab_offset(lay, ki, kj, c, stride))
    return tuple(out)


def int8_row_base(lay: Int8Layer, sl: Int8Slab, mb: int, t: int, r: int,
                  pos: int = 0) -> tuple:
    """(slab offset, output) of row ``r`` of A tile ``t`` of m-task
    ``mb``; the output is None past the last one, whose row reads output
    0's window. ``pos`` is the run-time window's position."""
    pw, ps = sl.pw or 1, sl.ps or 1
    i = j = 0
    if pw == 1:
        o = mb * 64 + t * 16 + r
    else:
        o = mb * 16 + r
        p = (t ^ (1 if lay.swz and r & 4 else 0)) if pw in (2, 3) else pos
        i, j = divmod(p, pw)
    valid = o < sl.n_wr * sl.n_wc
    wr, wc = divmod(o if valid else 0, sl.n_wc)
    return (wr * ps + i) * sl.stride * lay.rs + (wc * ps + j) * lay.cs, (o if valid else None)


def int8_w_offset(lay: Int8Layer, kk: int, n: int) -> int:
    """Byte of staged weight (K index ``kk``, channel ``n``): row n, its
    16-byte chunks swizzled within each 128-byte group (``sc_wchunk``)."""
    chunk, b = divmod(kk, 16)
    return n * lay.w_row + (chunk ^ ((n ^ (n >> 4)) & 7)) * 16 + b


def int8_wavefronts(lay: Int8Layer, sl: Int8Slab, tasks: int = 4) -> int:
    """Shared-memory wavefronts of the A loads of the first ``tasks``
    m-tasks' first K step: per ``ldmatrix`` phase (eight rows of 16
    bytes), the most distinct rows on one of the eight 16-byte bank
    groups; per 32-bit word load, the most distinct words on one bank."""
    mt, per = int8_tiles(sl.pw)
    m_tasks = min(tasks, -(-(sl.n_wr * sl.n_wc) // per))
    taps = int8_taps(lay, sl.k, sl.stride)
    total = 0
    for mb in range(m_tasks):
        for t in range(mt):
            rows = [int8_row_base(lay, sl, mb, t, r)[0] for r in range(16)]
            if lay.ldm:
                for half in (rows[:8], rows[8:]):
                    total += _most_on_one_bank({b // 16 for b in half}, 8)
                continue
            for r0, tap0 in ((0, 0), (8, 0), (0, 4), (8, 4)):
                words = {(rows[r0 + g] + taps[tap0 + tig]) // 4 for g in range(8)
                         for tig in range(4)}
                total += _most_on_one_bank(words, 32)
    return total


def _most_on_one_bank(units, banks: int) -> int:
    counts = [0] * banks
    for u in units:
        counts[u % banks] += 1
    return max(counts)


def int8_nt(pw: int, n: int, n_outputs: int) -> int:
    """n8 tiles per warp task: the most the pool window's kernel compiles
    that still gives each of a CTA's eight warps a task, else the
    fewest."""
    choices = I8_TILES_N.get(pw or 1, (1,))
    m_tasks = -(-n_outputs // int8_tiles(pw)[1])
    n_tiles = -(-n // 8)
    for nt in choices:
        if nt <= n_tiles and m_tasks * -(-n_tiles // nt) >= THREADS // 32:
            return nt
    return choices[-1]


@functools.lru_cache(maxsize=4096)
def int8_layer(sl: Int8Slab) -> Int8Layer:
    """The int8 layout of one layer: the column stride (C rounded up to
    16, or 16 more, on the ldmatrix path; C rounded up to 4 on the word
    path), the row pad and, at pool window 2, the position swizzle that
    put the A loads in the fewest wavefronts (``int8_wavefronts``), then
    the fewest bytes."""
    ldm = sl.c % 16 == 0
    cpad = sl.c if ldm else round_up(sl.c, 4)
    kdim = sl.k * sl.k * cpad
    kpad = round_up(kdim, MMA_K)
    q = -(-sl.cols // sl.stride)
    nt = int8_nt(sl.pw, sl.n, sl.n_wr * sl.n_wc)
    fixed = dict(cpad=cpad, q=q, rows=sl.rows, kdim=kdim, kpad=kpad, nt=nt,
                 n_pad=round_up(sl.n, 8 * nt), w_row=round_up(kpad, W_ROW_ALIGN))
    col_strides = (cpad, cpad + 16) if ldm else (cpad,)
    step = 16 if ldm else 4
    best = None
    for cs in col_strides:
        for pad in range(0, 128 if ldm else 64, step):
            for swz in ((0, 1) if sl.pw == 2 else (0,)):
                lay = Int8Layer(cs=cs, rs=sl.stride * q * cs + pad, swz=swz, **fixed)
                key = (int8_wavefronts(lay, sl), lay.slab_bytes, swz)
                if best is None or key < best[0]:
                    best = (key, lay)
    return best[1]


@functools.lru_cache(maxsize=1024)
def int8_layout(slabs: tuple) -> Int8Layout:
    """The int8 kernels' shared memory for a block of layers (one for the
    single-layer kernel): layer i's slab in buffer i % 2, one tap table
    and one layer's staged weights, each region on a 16-byte boundary.
    Every sizing of an int8 block (``pyramid_smem_bytes``,
    ``fused_geometry``, ``card_groups`` and the compiler's sizing of
    singletons) goes through here."""
    layers = tuple(int8_layer(sl) for sl in slabs)
    bufs = [0, 0]
    for i, lay in enumerate(layers):
        bufs[i % 2] = max(bufs[i % 2], round_up(lay.slab_bytes, 16))
    taps = round_up(4 * max(lay.kpad // lay.grain for lay in layers), 16)
    tap_off = bufs[0] + bufs[1]
    wst_off = tap_off + taps
    return Int8Layout(layers=layers, buf0=bufs[0], buf1=bufs[1], tap_off=tap_off,
                      wst_off=wst_off, smem=wst_off + max(lay.w_bytes for lay in layers))


# ---------------------------------------------------------------------------
# Single-layer fused conv.


def _block_multiple(k: int, s: int, pw: int, ps: int) -> tuple:
    """(legal block multiple, halo pixels, pool-overlap conv rows) for one
    spatial dim: the reference's rule, lcm(pool stride, hb/gcd(hb, s))."""
    overlap = max(0, pw - ps) if pw else 0
    hb = max(0, overlap * s + k - s)
    mult = 1
    if pw:
        mult = math.lcm(mult, ps)
    if hb:
        mult = math.lcm(mult, hb // math.gcd(hb, s))
    return mult, hb, overlap


def fused_geometry(h: int, wd: int, c: int, *, k: int, stride: int,
                   pool: int, pool_stride, block_r: int, block_w: int = 0,
                   n_out: int | None = None, n_slice: int | None = None,
                   elem_bytes: int = 4) -> dict:
    """Row and column blocking of the single-layer kernel over an already
    padded (h, wd, c) frame: conv rows per block ``r`` (a multiple of
    ``_block_multiple``), pooled rows per block ``r_o``, input rows per
    block (with the halo), the column ``strips`` (``halo.column_strips``:
    (first input column, end, first output column, end) per launch; one
    strip of the whole frame unless ``block_w``, conv columns per strip as
    the reference rounds them, is narrower than the conv output) and the
    block's shared-memory bytes for the widest strip, for ``n_slice``
    output channels (default ``n_out``). At ``elem_bytes=4`` (the fp32
    kernel) the slab with ``column_stride`` words per column, the tap
    table and two weight stages, laid out as the returned word offsets
    say; at 1 (the int8 kernel) the block's ``int8_layout``, whose byte
    offsets and per-layer fields are returned. Halves the row block toward
    the multiple until it fits; raises if even that does not."""
    pw, ps = normalize_pool(pool, pool_stride)
    s = stride
    h_out, w_out = (h - k) // s + 1, (wd - k) // s + 1
    h_keep = pool_out_dim(h_out, pw, ps) if pw else h_out
    w_keep = pool_out_dim(w_out, pw, ps) if pw else w_out
    mult, _, overlap = _block_multiple(k, s, pw, ps)
    if n_out is None:
        raise ValueError("fused_geometry needs n_out to size the kernels' weight stages")
    ns = n_out if n_slice is None else n_slice
    wc = round_up(max(block_w if block_w > 0 else w_out, mult), mult)
    if wc >= w_out:
        strips = ((0, wd, 0, w_keep),)  # the whole frame
        cols_in, cols_keep = wd, w_keep
    else:
        cols_keep = wc // ps if pw else wc
        strips = column_strips(wd, k, s, pw, ps, cols_keep)
        cols_in = (wc + overlap - 1) * s + k

    def layout(r):
        in_rows = (r + overlap - 1) * s + k
        r_o = r // ps if pw else r
        if elem_bytes == 1:
            lay = int8_layout((Int8Slab(rows=in_rows, cols=cols_in, c=c, k=k, stride=s, pw=pw,
                                        ps=ps, n=ns, n_wr=r_o, n_wc=cols_keep),))
            (li,) = lay.layers
            tasks = -(-r_o * cols_keep // int8_tiles(pw)[1]) * -(-ns // (8 * li.nt))
            i8 = dict(threads=32 * min(THREADS // 32, tasks), cs=li.cs, rs=li.rs, tn=li.nt,
                      np=li.n_pad, q=li.q, cpad=li.cpad, kpad=li.kpad, wrow=li.w_row,
                      swz=li.swz, tap_off=lay.tap_off, wst_off=lay.wst_off)
            return in_rows, i8, lay.smem
        tn, threads = fused_tile(pw, ns, r_o * cols_keep)
        np_, stage = _stage_words(ns, tn)
        cs = column_stride(c)
        rs = row_stride(cols_in, cs, (ps or 1) * s, cols_keep, r_o * cols_keep)
        tap_off = round_up(in_rows * rs, 4)
        wst_off = tap_off + _taps_words(k, c)
        fp32 = dict(threads=threads, cs=cs, rs=rs, tn=tn, np=np_, tap_off=tap_off, wst_off=wst_off,
                    wst_elems=stage)
        return in_rows, fp32, 4 * (wst_off + 2 * stage)

    r = round_up(max(block_r, mult), mult)
    r = min(r, round_up(h_out, mult))
    while True:
        in_rows, fp32, smem = layout(r)
        if smem <= SMEM_LIMIT or r == mult:
            break
        r = max(mult, round_up(r // 2, mult))
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"single-layer block of {r} conv rows needs {smem} B of shared "
            f"memory, above the {SMEM_LIMIT} B a Hopper block may use"
        )
    r_o = r // ps if pw else r
    slices = tuple((n0, min(n_out, n0 + ns)) for n0 in range(0, n_out, ns)) if n_out else ()
    return dict(
        path="mma_sync" if elem_bytes == 1 else "fma",
        r=r, r_o=r_o, in_rows_blk=in_rows, h_keep=h_keep, w_keep=w_keep,
        n_rb=-(-h_keep // r_o), smem=smem, strips=strips, slices=slices, **fp32,
    )


def fused_plan(h: int, wd: int, c: int, *, k: int, stride: int, pool: int,
               pool_stride, block_r: int, block_w: int = 0, n_out: int,
               elem_bytes: int = 4) -> dict:
    """The single-layer launcher's geometry. An int8 layer that
    ``fused_path`` sends to the wgmma path takes ``wgmma_geometry``.
    Every other layer takes ``fused_geometry``: the
    caller's ``block_w`` where the smallest row block fits in shared
    memory, else column strips halved until one fits, then slices of the
    output channels halved until one fits. Raises where even one strip of
    the narrowest legal width and one slice of four (fp32) or eight (int8)
    channels do not fit (fp32: a tap table of K * K * C words above the
    block, about 58,000). The result's ``path`` names the main loop:
    "wgmma", "mma_sync" (int8) or "fma" (fp32)."""
    pw, ps = normalize_pool(pool, pool_stride)
    if elem_bytes == 1 and fused_path(c, n_out, stride=stride, pw=pw, ps=ps) == "wgmma":
        return wgmma_geometry(h, wd, c, k=k, pw=pw, n_out=n_out, block_w=block_w)
    mult = _block_multiple(k, stride, pw, ps)[0]
    w_out = (wd - k) // stride + 1
    kw = dict(k=k, stride=stride, pool=pool, pool_stride=pool_stride, block_r=block_r,
              n_out=n_out, elem_bytes=elem_bytes)
    widths = [block_w]
    wc = round_up(max(block_w if block_w > 0 else w_out, mult), mult)
    while wc > mult:
        wc = max(mult, round_up(wc // 2, mult))
        widths.append(wc)
    slices, step = [n_out], 4 if elem_bytes == 4 else 8  # fp32 float4s, int8 n8 tiles
    while slices[-1] > step:
        slices.append(round_up(-(-slices[-1] // 2), step))
    err = None
    for ns in slices:
        for bw in widths:
            try:
                return fused_geometry(h, wd, c, block_w=bw, n_slice=ns, **kw)
            except ValueError as e:
                # Without its traceback: a kept traceback's frames would pin
                # the callers' frames, and their tensors, until the cyclic GC.
                err = e.with_traceback(None)
    raise err


# ---------------------------------------------------------------------------
# The single-layer int8 kernel's wgmma path (sc_fused_i8_wgmma in the
# source): a layer's weights stream through a ring in K steps, and a block
# covers every output channel of its outputs from one resident slab. The
# functions below mirror the kernel's address arithmetic, so the layout can
# be checked on the CPU.

WG_KS = 64  # SC_WG_KS: K bytes of one ring stage, a run of one tap's channels
WG_NT = 128  # SC_WG_NT: output channels of one N tile
WG_STAGE = WG_KS * WG_NT  # bytes of one ring stage
WG_THREADS = 384  # SC_WG_THREADS: two consumer warpgroups and the producer's
# Outputs of one block: two warpgroups x two m64 tiles of conv positions, or
# of 2x2 windows whose four positions one thread holds (32 a warpgroup).
WG_POSITIONS = 256
WG_WINDOWS = 64
WG_STAGES = (4, 8)  # ring stages: the fewest a block takes, the most it uses


def fused_path(c: int, n: int, *, stride: int, pw: int, ps: int) -> str:
    """The main loop of the single-layer int8 kernel for a layer of ``c``
    input and ``n`` output channels, conv ``stride`` and pool ``(pw, ps)``
    (``normalize_pool``'s): "wgmma" where a K step of ``WG_KS`` bytes stays
    inside one tap (C a multiple of it), N fills at least half an N tile,
    the conv stride is 1 and the pool none or 2x2/2; else "mma_sync", whose
    tap table also takes C of 1, 3, 20 and 32."""
    if c % WG_KS == 0 and n >= WG_KS and stride == 1 and (pw, ps) in ((0, 0), (2, 2)):
        return "wgmma"
    return "mma_sync"


def wgmma_row(*, pooled: bool, n_wc: int, rs: int, cs: int, swz: int, n_valid: int, wg: int,
              wi: int, t: int, rho: int) -> tuple:
    """(slab offset, output) of A row ``rho`` of warp ``wi``'s slice of m64
    tile ``t`` of consumer warpgroup ``wg`` (``sc_wg_row``): without a
    pool, conv position ``128 wg + 64 t + 16 wi + rho`` of the block, row
    major over ``n_wc`` columns; with the 2x2 pool, window ``32 wg + 8 wi +
    rho % 8`` at pool position ``(t, rho // 8)``, its column flipped for
    rows 4-7 and 12-15 where ``swz``. The output is None past the
    block's ``n_valid``, whose rows read output 0's."""
    if pooled:
        o = 32 * wg + 8 * wi + (rho & 7)
        valid = o < n_valid
        wr, wc = divmod(o if valid else 0, n_wc)
        pj = (rho >> 3) ^ (1 if swz and rho & 4 else 0)
        return (2 * wr + t) * rs + (2 * wc + pj) * cs, (o if valid else None)
    o = 128 * wg + 64 * t + 16 * wi + rho
    valid = o < n_valid
    pr, pc = divmod(o if valid else 0, n_wc)
    return pr * rs + pc * cs, (o if valid else None)


def wgmma_tap(kk: int, *, c: int, k: int, rs: int, cs: int) -> int:
    """Slab offset of K index ``kk`` ((ki, kj, c) order) from a row's
    base."""
    tap, ch = divmod(kk, c)
    ki, kj = divmod(tap, k)
    return ki * rs + kj * cs + ch


def wgmma_wavefronts(*, pooled: bool, n_wc: int, rs: int, cs: int, swz: int,
                     n_valid: int) -> int:
    """Shared-memory wavefronts of one K step's ``ldmatrix`` A loads of a
    block: per phase (eight rows of 16 bytes), the most distinct rows on
    one of the eight 16-byte bank groups (every K step shifts all rows
    alike)."""
    total = 0
    for wg, wi, t, half in itertools.product(range(2), range(4), range(2), range(2)):
        rows = {wgmma_row(pooled=pooled, n_wc=n_wc, rs=rs, cs=cs, swz=swz, n_valid=n_valid,
                          wg=wg, wi=wi, t=t, rho=8 * half + i)[0] for i in range(8)}
        total += _most_on_one_bank({r // 16 for r in rows}, 8)
    return total


def wgmma_w_offset(kk: int, n: int, *, ksteps: int) -> int:
    """Byte of weight (K index ``kk``, channel ``n``) in ``kmajor_weights``:
    N tile by N tile, K step by K step, one ``WG_STAGE``-byte ring stage
    each, which holds core matrices of 8 channels x 16 bytes (128
    contiguous bytes), the four of a group's K step 128 bytes apart, the
    groups of 8 channels 512 apart (``sc_wg_desc``)."""
    nt, nn = divmod(n, WG_NT)
    ks, kb = divmod(kk, WG_KS)
    return ((nt * ksteps + ks) * WG_STAGE + (nn // 8) * 512 + (kb // 16) * 128
            + (nn % 8) * 16 + kb % 16)


def kmajor_weights(w: torch.Tensor) -> torch.Tensor:
    """The wgmma path's weights: HWIO codes ``w`` (K, K, C, N) laid out
    once as the kernel streams them (``wgmma_w_offset``), N padded with
    zero channels to whole N tiles; flat int8 on ``w``'s device."""
    k, _, c, n = w.shape
    kdim, n_pad = k * k * c, round_up(n, WG_NT)
    wt = torch.zeros((n_pad, kdim), dtype=w.dtype, device=w.device)
    wt[:n] = w.reshape(kdim, n).t()
    v = wt.reshape(n_pad // WG_NT, WG_NT // 8, 8, kdim // WG_KS, WG_KS // 16, 16)
    return v.permute(0, 3, 1, 4, 2, 5).contiguous().reshape(-1)


@functools.lru_cache(maxsize=1024)
def _wgmma_slab(pooled: bool, cols_in: int, cs: int, n_wc: int, n_valid: int) -> tuple:
    """(row stride, swizzle) of a wgmma-path slab: the row pad and window
    swizzle that put the A loads in the fewest wavefronts, then the
    fewest bytes."""
    best = None
    for pad in range(0, 128, 16):
        for swz in ((0, 1) if pooled else (0,)):
            rs = cols_in * cs + pad
            key = (wgmma_wavefronts(pooled=pooled, n_wc=n_wc, rs=rs, cs=cs, swz=swz,
                                    n_valid=n_valid), rs, swz)
            best = key if best is None or key < best else best
    return best[1:]


def wgmma_geometry(h: int, wd: int, c: int, *, k: int, pw: int, n_out: int,
                   block_w: int = 0) -> dict:
    """The wgmma path's blocking of a stride-1 layer over an already padded
    (h, wd, c) frame, pool none (``pw`` 0) or 2x2/2: whole output rows a
    block, as many as ``WG_POSITIONS`` conv positions or ``WG_WINDOWS``
    windows hold, spread evenly over the row blocks; column strips only
    where one output row is more than that, or ``block_w`` asks for them;
    one channel slice (a block walks every N tile). The slab keeps a
    column of C + 16 bytes and the row pad and window swizzle that put
    the A loads in the fewest wavefronts (``wgmma_wavefronts``), then
    the ring of ``WG_STAGES`` stages and its 2 mbarriers a stage. While
    the slab leaves no room for the fewest stages, rows are halved, and
    at one row the strips' columns; raises only where one output a block
    does not fit either (C above about 12,000). Returns
    ``fused_geometry``'s keys (``tap_off`` and ``wst_off`` both the
    ring's offset: there is no tap table) and ``stages``."""
    pooled = pw == 2
    h_out, w_out = h - k + 1, wd - k + 1
    h_keep = h_out // 2 if pooled else h_out
    w_keep = w_out // 2 if pooled else w_out
    cap = WG_WINDOWS if pooled else WG_POSITIONS
    cols_keep = min(w_keep, cap)
    if block_w > 0:
        cols_keep = min(cols_keep, max(1, round_up(block_w, 2) // 2 if pooled else block_w))
    cs = c + 16
    kdim = k * k * c
    n_tiles = -(-n_out // WG_NT)
    rows = cap // cols_keep
    while True:
        if cols_keep < w_keep:
            strips = column_strips(wd, k, 1, 2 if pooled else 0, 2 if pooled else 0, cols_keep)
            cols_in = (2 * cols_keep if pooled else cols_keep) + k - 1
        else:
            strips, cols_in = ((0, wd, 0, w_keep),), wd
        n_rb = -(-h_keep // rows)
        r_o = -(-h_keep // n_rb)
        r = 2 * r_o if pooled else r_o
        in_rows = r + k - 1
        rs, swz = _wgmma_slab(pooled, cols_in, cs, cols_keep, r_o * cols_keep)
        ring_off = round_up(in_rows * rs, 128)
        stages = min(WG_STAGES[1], (SMEM_LIMIT - ring_off) // (WG_STAGE + 16))
        if stages >= WG_STAGES[0]:
            break
        if rows > 1:
            rows //= 2
        elif cols_keep > 1:
            cols_keep = -(-cols_keep // 2)
        else:
            raise ValueError(
                f"wgmma path: a slab of {in_rows} rows of {rs} B leaves no room for "
                f"{WG_STAGES[0]} weight stages in {SMEM_LIMIT} B")
    return dict(
        path="wgmma", r=r, r_o=r_o, in_rows_blk=in_rows, h_keep=h_keep, w_keep=w_keep,
        n_rb=n_rb, smem=ring_off + stages * (WG_STAGE + 16), strips=strips,
        slices=((0, n_out),), threads=WG_THREADS, cs=cs, rs=rs, tn=n_tiles,
        np=n_tiles * WG_NT, q=cols_in, cpad=c, kpad=kdim, wrow=WG_KS, swz=swz,
        tap_off=ring_off, wst_off=ring_off, stages=stages,
    )


def _int8_operands(name: str, int8_scales, act_bits) -> tuple:
    """(element dtype, bytes per slab element) of a launch: fp32, or with
    ``int8_scales`` the int8 rendering, which needs every layer's stream
    grid."""
    if int8_scales is None:
        return torch.float32, 4
    if any(b is None for b in act_bits):
        raise ValueError(f"{name}: int8_scales requires act_bits on every layer")
    return torch.int8, 1


def _weights_16b(w: torch.Tensor) -> int:
    """Whether the kernel may copy rows of ``w`` 16 bytes at a time."""
    return int(w.shape[-1] % 4 == 0 and w.data_ptr() % 16 == 0)


def stream_conv_fused_cuda(
    x: torch.Tensor,  # (B, H, W, C), already SAME-padded
    w: torch.Tensor,  # (K, K, C, N) HWIO
    bias: torch.Tensor,  # (N,)
    *,
    stride: int = 1,
    act: str = "none",
    pool: int = 0,
    pool_stride: int | None = None,
    act_bits: int | None = None,
    int8_scales=None,
    block_r: int = 8,
    block_w: int = 0,
    w_kmajor: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused streaming conv on the card: VALID conv of stride ``stride``
    over the padded frame, then bias -> act -> pool -> quant. Returns
    (B, H', W', N) with H', W' the pooled output dims. One launch per
    column strip and channel slice of ``fused_plan``, all into one output
    tensor (one launch where the frame fits).

    With ``int8_scales`` (an ``epilogue.Int8Scales``) ``x`` and ``w`` must
    be int8 codes (the frame padded with code 0) and the int8 kernel runs:
    int32 accumulation, ``deq_scale`` dequantization, fp32 values out. On
    its wgmma path it reads ``w`` as ``kmajor_weights(w)``, which a plan
    lays out once and passes as ``w_kmajor``; without it the launch lays
    them out first."""
    b_, h, wd, c = x.shape
    k, n = w.shape[0], w.shape[3]
    dtype, elem_bytes = _int8_operands("stream_conv_fused", int8_scales, (act_bits,))
    _check_cuda("x", x, dtype=dtype)
    _check_cuda("w", w, (k, k, c, n), dtype=dtype)
    _check_cuda("bias", bias, (n,))
    pw, ps = normalize_pool(pool, pool_stride)
    if b_ > 65535:
        raise ValueError(f"batch {b_} above the grid's 65535 images")
    g = fused_plan(h, wd, c, k=k, stride=stride, pool=pool, pool_stride=pool_stride,
                   block_r=block_r, block_w=block_w, n_out=n, elem_bytes=elem_bytes)
    out = torch.empty((b_, g["h_keep"], g["w_keep"], n), device=x.device,
                      dtype=torch.float32)
    int8 = int8_scales is not None
    name = "stream_conv_fused_int8" if int8 else "stream_conv_fused"
    lib = _library()
    launch = lib.sc_fused_i8_launch if int8 else lib.sc_fused_launch
    e_x, e_w = x.element_size(), w.element_size()
    common = dict(
        batch=b_, h=h, c=c, k=k, stride=stride, act=ACT_CODES[act], pw=pw or 1, ps=ps or 1,
        **_quant_fields(act_bits), h_keep=g["h_keep"], r=g["r"], r_o=g["r_o"],
        in_rows_blk=g["in_rows_blk"], n_rb=g["n_rb"],
        deq=int8_scales.deq_scale if int8 else 1.0,
        x_img=h * wd * c, out_img=g["h_keep"] * g["w_keep"] * n, x_rs=wd * c,
        out_rs=g["w_keep"] * n, out_cs=n, w_ld=n,
    )
    common.update(threads=g["threads"], cs=g["cs"], rs=g["rs"], tn=g["tn"], np=g["np"],
                  tap_off=g["tap_off"], wst_off=g["wst_off"])
    if int8:
        common.update(q=g["q"], cpad=g["cpad"], kpad=g["kpad"], wrow=g["wrow"], swz=g["swz"])
    else:
        common.update(wst_elems=g["wst_elems"])
    wg = g["path"] == "wgmma"
    if wg:
        if w_kmajor is None:
            w_kmajor = kmajor_weights(w)
        _check_cuda("w_kmajor", w_kmajor, (g["np"] * g["kpad"],), dtype=torch.int8)
        if x.data_ptr() % 16:  # the slab's 16-byte copies
            x = x.clone()
        w = w_kmajor
        common.update(wg=1, stages=g["stages"],
                      grid=min(g["n_rb"] * b_, sm_count(x.device)))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for in_lo, in_hi, o_lo, o_hi in g["strips"]:
            for n0, n1 in g["slices"]:
                wvec = int(not int8 and n % 4 == 0 and n0 % 4 == 0 and (n1 - n0) % 4 == 0
                           and w.data_ptr() % 16 == 0)
                desc = _ScFused(
                    x=x.data_ptr() + in_lo * c * e_x, w=w.data_ptr() + n0 * e_w,
                    b=bias.data_ptr() + n0 * 4, out=out.data_ptr() + (o_lo * n + n0) * 4,
                    w_in=in_hi - in_lo, w_keep=o_hi - o_lo, n=n1 - n0, wvec=wvec, **common,
                )
                _raise_on(launch(ctypes.addressof(desc), g["smem"], stream), name)
                LAUNCHES[name] += 1
                if int8:
                    PATH_LAUNCHES[g["path"]] += 1
                probe.launched(name, g["smem"], stream)
    return out


# ---------------------------------------------------------------------------
# Cross-layer fused pyramid.


def int8_pyramid_slabs(geom) -> tuple:
    """The int8 pyramid's layers as ``Int8Slab``s: each slab holds the
    rows ``pyramid_rows`` says the widest row block reads (the fp32
    kernel's walk), each layer's tiles sized for the most outputs a block
    computes."""
    per_block = [pyramid_rows(geom, rb) for rb in range(geom.n_row_blocks)]
    return tuple(
        Int8Slab(rows=max(r[i][3] - r[i][2] for r in per_block),
                 cols=g.in_cols + g.pads[1][0] + g.pads[1][1], c=g.in_ch, k=g.k,
                 stride=g.stride, pw=g.pw, ps=g.ps, n=g.n_out,
                 n_wr=max(r[i][1] - r[i][0] for r in per_block), n_wc=g.out_cols)
        for i, g in enumerate(geom.layers))


@functools.lru_cache(maxsize=256)
def int8_pyramid_layout(geom) -> Int8Layout:
    """The int8 pyramid kernel's ``int8_layout`` for a group geometry."""
    return int8_layout(int8_pyramid_slabs(geom))


def pyramid_rows(geom, rb: int) -> tuple:
    """Per layer, the rows the fp32 pyramid kernel handles in row block
    ``rb``: (olo, ohi) the output rows it computes, in out-slab
    coordinates, and (ilo, ihi) the input rows they read, in in-slab
    coordinates. Walked from the last layer back: a layer computes the
    rows of the next layer's frame that the next layer reads. The
    kernel's opening loop is the same walk."""
    n = len(geom.layers)
    rows = [None] * n
    for li in reversed(range(n)):
        g = geom.layers[li]
        if li + 1 < n:
            nx = geom.layers[li + 1]
            start = nx.in_mult * rb + nx.in_off
            lo = max(0, -start, rows[li + 1][2])
            hi = min(g.out_slab_rows, nx.in_rows - start, rows[li + 1][3])
        else:
            lo = 0
            hi = min(geom.block_rows, geom.out_rows - rb * geom.block_rows)
        if hi > lo:
            pw, ps = g.pw or 1, g.ps or 1
            ilo, ihi = lo * ps * g.stride, ((hi - 1) * ps + pw - 1) * g.stride + g.k
        else:
            ilo = ihi = 0
        rows[li] = (lo, hi, ilo, ihi)
    return tuple(rows)


@dataclasses.dataclass(frozen=True)
class PyramidLayout:
    """The fp32 pyramid kernel's shared memory, in 4-byte words: two
    ping-pong slab buffers (``buf0`` then ``buf1`` words), the tap table
    at ``tap_off`` and two weight stages of ``wst_elems`` at ``wst_off``.
    Per layer: the slab's column and row strides ``cs`` and ``rs``, the
    slab rows stored, the channels per thread ``tn`` and the staged weight
    row stride ``np``."""

    cs: tuple
    rs: tuple
    slab_rows: tuple
    tn: tuple
    np: tuple
    buf0: int
    buf1: int
    tap_off: int
    wst_off: int
    wst_elems: int

    @property
    def smem(self) -> int:
        return 4 * (self.wst_off + 2 * self.wst_elems)


@functools.lru_cache(maxsize=256)
def pyramid_layout(geom) -> PyramidLayout:
    """The fp32 pyramid kernel's shared-memory layout for a group
    geometry: each slab holds the rows ``pyramid_rows`` says the widest
    row block reads, at ``column_stride`` and ``row_stride``."""
    per_block = [pyramid_rows(geom, rb) for rb in range(geom.n_row_blocks)]
    cs, rs, slab_rows, tn, np_ = [], [], [], [], []
    bufs, taps, stage = [0, 0], 0, 0
    for i, g in enumerate(geom.layers):
        cols = g.in_cols + g.pads[1][0] + g.pads[1][1]
        windows = max(r[i][1] - r[i][0] for r in per_block) * g.out_cols
        cs.append(column_stride(g.in_ch))
        rs.append(row_stride(cols, cs[-1], (g.ps or 1) * g.stride, g.out_cols, windows))
        slab_rows.append(max(r[i][3] - r[i][2] for r in per_block))
        tn.append(tile_n(g.pw, g.n_out, windows))
        w_row, words = _stage_words(g.n_out, tn[-1])
        np_.append(w_row)
        bufs[i % 2] = max(bufs[i % 2], round_up(slab_rows[-1] * rs[-1], 4))
        taps = max(taps, _taps_words(g.k, g.in_ch))
        stage = max(stage, words)
    tap_off = bufs[0] + bufs[1]
    return PyramidLayout(
        cs=tuple(cs), rs=tuple(rs), slab_rows=tuple(slab_rows), tn=tuple(tn),
        np=tuple(np_), buf0=bufs[0], buf1=bufs[1], tap_off=tap_off,
        wst_off=tap_off + taps, wst_elems=stage,
    )


def pyramid_smem_bytes(geom, elem_bytes: int = 4) -> int:
    """Shared memory one pyramid block needs for this group geometry: the
    fp32 kernel's ``pyramid_layout`` at ``elem_bytes=4``, the int8
    kernel's ``int8_pyramid_layout`` at 1."""
    if elem_bytes == 1:
        return int8_pyramid_layout(geom).smem
    return pyramid_layout(geom).smem


def card_groups(h: int, w: int, c: int, layers, kernels, n_outs, groups, *,
                elem_bytes: int = 4) -> tuple:
    """The reference's fusion groups of one stage, split into groups the
    card can take. ``layers`` (``halo.PyramidLayer``), ``kernels`` and
    ``n_outs`` describe the stage's conv layers from an (h, w, c) frame;
    ``groups`` are the reference's ``(local layer indices, block_rows)``
    pairs. A multi-layer group is kept where it has at most
    ``MAX_PYRAMID_LAYERS`` layers and its pyramid fits ``SMEM_LIMIT`` at
    the reference's ``block_rows``; otherwise it is cut, left to right,
    into the longest runs that fit at some ``block_rows`` (the whole frame,
    then halved down to one row, the reference's ladder), the largest that
    fits. A layer that fits no run with its successor is a singleton, which
    the single-layer kernel serves (it blocks rows, columns and channels).
    Returns the same kind of pairs; singletons have ``block_rows`` 0."""
    layers, kernels, n_outs = tuple(layers), tuple(kernels), tuple(n_outs)
    frames = [(h, w, c)]
    for i in range(len(layers) - 1):
        g = group_geometry(*frames[-1], layers[i:i + 1], kernels[i:i + 1], n_outs[i:i + 1])
        frames.append((g.out_rows, g.out_cols, n_outs[i]))

    def fit(i, j, first):
        if j - i > MAX_PYRAMID_LAYERS:
            return None
        out_rows = group_geometry(*frames[i], layers[i:j], kernels[i:j], n_outs[i:j]).out_rows
        ladder, r = [], out_rows
        while True:
            ladder.append(r)
            if r == 1:
                break
            r = -(-r // 2)
        for r in ([first] if first else []) + ladder:
            geom = group_geometry(*frames[i], layers[i:j], kernels[i:j], n_outs[i:j],
                                  block_rows=r)
            if pyramid_smem_bytes(geom, elem_bytes) <= SMEM_LIMIT:
                return r
        return None

    out = []
    for idxs, block_rows in groups:
        idxs = tuple(idxs)
        if len(idxs) == 1:
            out.append((idxs, 0))
            continue
        if fit(idxs[0], idxs[-1] + 1, block_rows) == block_rows and block_rows:
            out.append((idxs, block_rows))
            continue
        i, end = idxs[0], idxs[-1] + 1
        while i < end:
            for j in range(end, i + 1, -1):
                r = fit(i, j, None)
                if r is not None:
                    out.append((tuple(range(i, j)), r))
                    break
            else:
                j = i + 1
                out.append(((i,), 0))
            i = j
    return tuple(out)


def _pyramid_desc(x, weights, biases, out, geom, act_bits, int8_scales) -> _ScPyramid:
    int8 = int8_scales is not None
    lay = int8_pyramid_layout(geom) if int8 else pyramid_layout(geom)
    layer_descs = []
    for i, (g, w, b) in enumerate(zip(geom.layers, weights, biases)):
        if int8:
            li = lay.layers[i]
            fields = dict(cs=li.cs, rs=li.rs, tn=li.nt, np=li.n_pad, q=li.q, cpad=li.cpad,
                          kpad=li.kpad, wrow=li.w_row, swz=li.swz)
        else:
            fields = dict(cs=lay.cs[i], rs=lay.rs[i], tn=lay.tn[i], np=lay.np[i],
                          wvec=_weights_16b(w))
        layer_descs.append(
            _ScLayer(
                w=w.data_ptr(), b=b.data_ptr(), k=g.k, stride=g.stride,
                act=ACT_CODES[g.act], pw=g.pw or 1, ps=g.ps or 1,
                **_quant_fields(act_bits[i]),
                in_rows=g.in_rows, in_cols=g.in_cols, in_ch=g.in_ch,
                pad_l=g.pads[1][0], pad_r=g.pads[1][1],
                out_cols=g.out_cols, n_out=g.n_out,
                in_mult=g.in_mult, in_off=g.in_off,
                in_slab_rows=g.in_slab_rows, out_slab_rows=g.out_slab_rows,
                deq=int8_scales[i].deq_scale if int8 else 1.0,
                **fields,
            )
        )
    desc = _ScPyramid(
        x=x.data_ptr(), out=out.data_ptr(), batch=x.shape[0],
        n_layers=len(geom.layers), n_rb=geom.n_row_blocks,
        block_rows=geom.block_rows, out_rows=geom.out_rows,
        buf0_elems=lay.buf0, tap_off=lay.tap_off, wst_off=lay.wst_off,
        wst_elems=0 if int8 else lay.wst_elems,
    )
    for i, d in enumerate(layer_descs):
        desc.L[i] = d
    return desc


def stream_conv_pyramid_cuda(
    x: torch.Tensor,  # (B, H, W, C0), unpadded
    weights,  # per layer (K, K, C, N) HWIO
    biases,  # per layer (N,)
    *,
    geom,  # halo.GroupGeometry of the group
    act_bits: tuple,  # per layer int | None
    int8_scales=None,  # None | per-layer tuple of Int8Scales
) -> torch.Tensor:
    """Cross-layer fused conv pyramid on the card: the whole group in one
    launch. Returns the group output (B, H', W', N_last).

    With ``int8_scales`` the frame and the weights must be int8 codes and
    the int8 kernel runs: int8 slabs, int32 accumulation, ``deq_scale``
    dequantization per layer, int8 codes between layers and fp32 values
    out of the last one."""
    n_layers = len(geom.layers)
    if n_layers > MAX_PYRAMID_LAYERS:
        raise NotImplementedError(
            f"the pyramid kernel takes up to {MAX_PYRAMID_LAYERS} layers, "
            f"got {n_layers}"
        )
    dtype, elem_bytes = _int8_operands("stream_conv_pyramid", int8_scales, act_bits)
    g0 = geom.layers[0]
    b_ = x.shape[0]
    _check_cuda("x", x, (b_, g0.in_rows, g0.in_cols, g0.in_ch), dtype=dtype)
    if b_ > 65535:
        raise ValueError(f"batch {b_} above the grid's 65535 images")
    smem = pyramid_smem_bytes(geom, elem_bytes)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"pyramid block needs {smem} B of shared memory, above the "
            f"{SMEM_LIMIT} B a Hopper block may use (block_rows="
            f"{geom.block_rows})"
        )
    for i, (g, w, b) in enumerate(zip(geom.layers, weights, biases)):
        _check_cuda(f"weights[{i}]", w, (g.k, g.k, g.in_ch, g.n_out), dtype=dtype)
        _check_cuda(f"biases[{i}]", b, (g.n_out,))
    last = geom.layers[-1]
    out = torch.empty((b_, geom.out_rows, geom.out_cols, last.n_out),
                      device=x.device, dtype=torch.float32)
    desc = _pyramid_desc(x, weights, biases, out, geom, act_bits, int8_scales)
    name = "stream_conv_pyramid" if int8_scales is None else "stream_conv_pyramid_int8"
    lib = _library()
    launch = lib.sc_pyramid_launch if int8_scales is None else lib.sc_pyramid_i8_launch
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(ctypes.addressof(desc), smem, stream)
    _raise_on(err, name)
    LAUNCHES[name] += 1
    probe.launched(name, smem, stream)
    return out


# ---------------------------------------------------------------------------
# The gradient of a group (csrc/stream_conv_bwd.cu).

BWD_SMEM_TARGET = 100 * 1024  # a dW block's shared memory the planner aims under
BWD_MAX_POOL = 15  # the winner's index is one byte: pool windows up to 15 x 15
BWD_MAX_WARPS = 16  # warps of a recompute or dx CTA (__launch_bounds__(512))
BWD_PARTS_PER_SM = 2  # dW CTAs (K tiles x shares) the planner aims at per SM


class _ScbLayer(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in (
        "batch", "hi", "wi", "c", "pt", "pl", "k", "s", "hc", "wc", "pw", "ps", "hq", "wq",
        "n", "act", "qbits")] + [(f, ctypes.c_float) for f in (
            "qscale", "qmin", "qmax", "qlo", "qhi")]


class _ScbConv(ctypes.Structure):
    _fields_ = [("L", _ScbLayer)] + [(f, ctypes.c_void_p) for f in (
        "x", "w", "b", "g", "gate", "idx", "out", "gate_out", "idx_out")] + [
        (f, ctypes.c_int) for f in ("rows", "n_rb", "cs", "rs", "np", "ys", "tap_off",
                                    "wst_off", "y_off", "threads", "wpt", "tn", "kc")]


class _ScbGrad(ctypes.Structure):
    _fields_ = [("L", _ScbLayer)] + [(f, ctypes.c_void_p) for f in (
        "x", "g", "gate", "idx", "part")] + [
        (f, ctypes.c_int) for f in ("rows", "n_rb", "units", "parts", "cs", "rs", "np",
                                    "dz_off", "kth", "ng", "threads", "tk", "tn")]


class _ScbReduce(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p * MAX_PYRAMID_LAYERS) for f in ("part", "dw", "db")] + [
        (f, ctypes.c_int * MAX_PYRAMID_LAYERS) for f in ("kk1", "n", "parts")] + [
        ("layers", ctypes.c_int)]


def _bwd_library() -> ctypes.CDLL:
    lib = _nvcc.load("stream_conv_bwd")
    if not getattr(lib, "_scb_checked", False):
        for fn, struct in ((lib.scb_conv_desc_bytes, _ScbConv),
                           (lib.scb_grad_desc_bytes, _ScbGrad),
                           (lib.scb_reduce_desc_bytes, _ScbReduce)):
            fn.argtypes, fn.restype = [], ctypes.c_int
            if fn() != ctypes.sizeof(struct):
                raise RuntimeError(
                    f"{struct.__name__} is {ctypes.sizeof(struct)} B in Python "
                    f"but {fn()} B in the library: the layouts disagree"
                )
        lib.scb_conv_launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_void_p]
        lib.scb_dw_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]
        lib.scb_reduce_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        for fn in (lib.scb_conv_launch, lib.scb_dw_launch, lib.scb_reduce_launch):
            fn.restype = ctypes.c_int
        lib._scb_checked = True
    return lib


def _ladder(n: int) -> tuple:
    """n, then halved (rounded up) down to 1: the row blocks tried."""
    out = [n]
    while out[-1] > 1:
        out.append(-(-out[-1] // 2))
    return tuple(out)


def bwd_conv_tiles(m: int, nout: int) -> tuple:
    """The compiled tiles of a recompute or dx block of ``m`` positions and
    ``nout`` output channels: (positions a thread, channels a thread,
    warps, rounds) for 4, 2 or 1 positions x 8 or 4 channels, a warp task
    being 16 x positions x 2 channel groups, one warp a task up to
    ``BWD_MAX_WARPS`` and the tasks dealt round by round."""
    out = []
    for tn in (8, 4):
        gpairs = -(-(-(-nout // tn)) // 2)
        for wpt in (4, 2, 1):
            tasks = -(-m // (16 * wpt)) * gpairs
            warps = min(BWD_MAX_WARPS, tasks)
            out.append((wpt, tn, warps, -(-tasks // warps)))
    return tuple(out)


def bwd_conv_cost(*, ctas: int, sms: int, smem: int, warps: int, rounds: int, wpt: int,
                  tn: int, kdim: int, staged: int, slab: int) -> float:
    """A launch's time in SM issue slots, to rank the planner's choices: a
    CTA's threads each issue, a K row, ``wpt * tn`` FMAs and ``wpt + tn /
    4`` shared loads a round, and stage ``staged`` weight and ``slab``
    slab elements with the CTA, each weighed as 16 instructions (index
    arithmetic and a load from L2 that few warps hide); an SM issues 4
    warp instructions a clock given 4 warps a scheduler, fewer with fewer
    (the CTAs it holds at once by shared memory, threads and the grid)."""
    threads = 32 * warps
    per_thread = rounds * round_up(kdim, 4) * (wpt * tn + wpt + tn / 4) \
        + 16 * (staged + slab) / threads
    held = max(1, min((SMEM_LIMIT + 1024) // (smem + 1024), 2048 // threads, 32,
                      -(-ctas // sms)))
    rate = min(4.0, held * warps / 4)
    return -(-ctas // (sms * held)) * held * warps * per_thread / rate


def bwd_dw_tile(kk1: int, n: int) -> dict:
    """The dW kernel's thread tile for ``kk1`` K rows (k*k*c and db's) and
    ``n`` channels: TN = 8 or 4 channels a thread in ``ng`` groups, ``kth``
    K threads of up to 256, ``tk`` K rows each (at most 8) over ``ktiles``
    tiles, the rows spread evenly; the TN with the fewer padded slots."""
    best = None
    for tn in (8, 4):
        ng = -(-n // tn)
        kth = min(THREADS // ng, kk1)
        rows = -(-kk1 // kth)
        ktiles = -(-rows // 8)
        tk = -(-kk1 // (kth * ktiles))
        slots = ktiles * kth * tk * ng * tn
        if best is None or slots < best[0]:
            best = (slots, dict(tn=tn, ng=ng, kth=kth, tk=tk, ktiles=ktiles,
                                threads=round_up(ng * kth, 32)))
    return best[1]


def _bwd_conv_launch(g, batch: int, sms: int, dx: bool) -> dict:
    """A recompute (``dx`` False) or dx launch of one layer (``halo.LayerGeom``
    ``g``): the block's rows (pooled rows, or dx's input rows), tile and
    weight stage of least ``bwd_conv_cost`` among those whose shared
    memory fits: the slab (the input rows with zeros in the pads, or dz
    dilated by the stride), the tap table, a stage of ``K_STAGE`` weight
    rows (restaged every round) or of all of them (staged once) and, for
    the recompute, the block's sums. Raises where one row does not fit."""
    pw, ps = g.pw or 1, g.ps or 1
    hc, wc = (g.out_rows - 1) * ps + pw, (g.out_cols - 1) * ps + pw
    kin, nout = (g.n_out, g.in_ch) if dx else (g.in_ch, g.n_out)
    cs = column_stride(kin)
    kdim = g.k * g.k * kin
    ys = 0 if dx else g.n_out | 1
    best = None
    for rows in _ladder(g.in_rows if dx else g.out_rows):
        if dx:
            m_rows, m_cols, step = rows, g.in_cols, 1
            s_rows, s_cols = rows + g.k - 1, g.in_cols + g.k - 1
        else:
            m_rows, m_cols, step = (rows - 1) * ps + pw, wc, g.stride
            s_rows, s_cols = (m_rows - 1) * g.stride + g.k, (wc - 1) * g.stride + g.k
        m = m_rows * m_cols
        rs = row_stride(s_cols, cs, step, m_cols, m)
        tap_off = round_up(s_rows * rs, 4)
        wst_off = tap_off + round_up(kdim, 4)
        n_rb = -(-(g.in_rows if dx else g.out_rows) // rows)
        for (wpt, tn, warps, rounds), kc in itertools.product(
                bwd_conv_tiles(m, nout), (K_STAGE, round_up(kdim, 4))):
            np_ = round_up(nout, tn)
            if dx and np_ % 8 == 0:
                np_ += 4  # the staging's column writes fall on 8 banks, not 1
            y_off = wst_off + kc * np_
            smem = 4 * (y_off + m * ys)
            if smem > SMEM_LIMIT:
                continue
            stages = 1 if kc >= kdim else rounds
            cost = bwd_conv_cost(ctas=batch * n_rb, sms=sms, smem=smem, warps=warps,
                                 rounds=rounds, wpt=wpt, tn=tn, kdim=kdim,
                                 staged=stages * round_up(kdim, kc) * np_,
                                 slab=s_rows * s_cols * kin * (4 if dx else 1))
            d = dict(rows=rows, n_rb=n_rb, cs=cs, rs=rs, np=np_, ys=ys, tap_off=tap_off,
                     wst_off=wst_off, y_off=0 if dx else y_off, threads=32 * warps, wpt=wpt,
                     tn=tn, kc=kc, smem=smem, hc=hc, wc=wc)
            if best is None or cost < best[0]:
                best = (cost, d)
    if best is None:
        raise ValueError(
            f"stream-conv backward: one row of a {g.in_rows}x{g.in_cols}x{g.in_ch} frame "
            f"needs more than the {SMEM_LIMIT} B of shared memory a block may use")
    return best[1]


def _bwd_dw(g, batch: int, sms: int, hc: int, wc: int) -> dict:
    """A dW launch of one layer: the conv rows a unit (the largest whose
    staged frame rows, with a channel of ones, and dz stay under
    ``BWD_SMEM_TARGET`` and that give ``BWD_PARTS_PER_SM`` units an SM
    over the K tiles, else the smallest that fits), the tile
    (``bwd_dw_tile``) and the shares: ``BWD_PARTS_PER_SM`` CTAs an SM over
    the K tiles, at most one a unit."""
    kk1 = g.k * g.k * g.in_ch + 1
    tile = bwd_dw_tile(kk1, g.n_out)
    np_ = tile["ng"] * tile["tn"]
    cs = column_stride(g.in_ch + 1)
    s_cols = (wc - 1) * g.stride + g.k
    choice = None
    for rows in _ladder(hc):
        s_rows = (rows - 1) * g.stride + g.k
        rs = s_cols * cs
        dz_off = round_up(s_rows * rs, 4)
        smem = 4 * (dz_off + rows * wc * np_)
        if smem <= SMEM_LIMIT:
            choice = dict(rows=rows, cs=cs, rs=rs, dz_off=dz_off, smem=smem)
            if (smem <= BWD_SMEM_TARGET and batch * -(-hc // rows) * tile["ktiles"]
                    >= BWD_PARTS_PER_SM * sms):
                break
    if choice is None:
        raise ValueError(
            f"stream-conv backward: one conv row of dW of a {g.in_rows}x{g.in_cols}x{g.in_ch} "
            f"frame needs more than the {SMEM_LIMIT} B of shared memory a block may use")
    n_rb = -(-hc // choice["rows"])
    units = batch * n_rb
    parts = max(1, min(units, -(-BWD_PARTS_PER_SM * sms // tile["ktiles"])))
    return dict(choice, np=np_, n_rb=n_rb, units=units, parts=parts, kk1=kk1, **tile)


@dataclasses.dataclass(frozen=True)
class BwdLayerPlan:
    """One layer of a group's backward: ``frame``, the ``_ScbLayer``
    geometry (its integer fields; the grid's floats are the epilogue's),
    and the launches ``recompute``, ``dx`` (None where no dx is needed)
    and ``dw``, each the kernel's tile and shared memory."""

    frame: dict
    recompute: dict
    dx: Optional[dict]
    dw: dict


def bwd_plan(geom, batch: int, sms: int, need_dx: bool) -> tuple:
    """The launches of a group's backward on a card of ``sms`` SMs, for a
    group geometry (``halo.group_geometry`` at one block) and a batch:
    per layer a ``BwdLayerPlan``; dx for every layer but the first, and
    for the first where ``need_dx``. Raises where a pool window is above
    ``BWD_MAX_POOL`` or a block does not fit in shared memory."""
    out = []
    for i, g in enumerate(geom.layers):
        pw, ps = g.pw or 1, g.ps or 1
        if pw > BWD_MAX_POOL:
            raise ValueError(f"stream-conv backward: pool window {pw} above {BWD_MAX_POOL}")
        rec = _bwd_conv_launch(g, batch, sms, False)
        frame = dict(batch=batch, hi=g.in_rows, wi=g.in_cols, c=g.in_ch, pt=g.pads[0][0],
                     pl=g.pads[1][0], k=g.k, s=g.stride, hc=rec["hc"], wc=rec["wc"], pw=pw,
                     ps=ps, hq=g.out_rows, wq=g.out_cols, n=g.n_out, act=ACT_CODES[g.act])
        dx = _bwd_conv_launch(g, batch, sms, True) if (i or need_dx) else None
        out.append(BwdLayerPlan(frame=frame, recompute=rec, dx=dx,
                                dw=_bwd_dw(g, batch, sms, rec["hc"], rec["wc"])))
    return tuple(out)


def bwd_launches(n_layers: int, need_dx: bool) -> int:
    """Launches of a group's backward: a recompute, a dW and a dx a layer,
    but no dx for the first layer unless ``need_dx``, and one reduction."""
    return 3 * n_layers + need_dx


def check_bwd_operands(x, weights, biases, g, geom) -> None:
    """The backward wrapper's checks of dtype, shape and contiguity (every
    device): float32 throughout, the group input and weights as the
    geometry says, the gradient the group output's shape."""
    layers = geom.layers
    b_ = x.shape[0]
    g0, last = layers[0], layers[-1]
    named = [("x", x, (b_, g0.in_rows, g0.in_cols, g0.in_ch)),
             ("g", g, (b_, last.out_rows, last.out_cols, last.n_out))]
    for i, (lg, w, b) in enumerate(zip(layers, weights, biases)):
        named += [(f"weights[{i}]", w, (lg.k, lg.k, lg.in_ch, lg.n_out)),
                  (f"biases[{i}]", b, (lg.n_out,))]
    for name, t, shape in named:
        _check_operand(name, t, shape)


def stream_conv_pyramid_bwd_cuda(
    x: torch.Tensor,  # (B, H, W, C0), unpadded: the group input
    weights,  # per layer (K, K, C, N) HWIO
    biases,  # per layer (N,)
    g: torch.Tensor,  # (B, H', W', N_last): the group output's gradient
    *,
    layers,  # halo.PyramidLayer per layer
    act_bits: tuple,  # per layer int | None
    need_dx: bool,
) -> tuple:
    """The gradient of one fp32 / fake-quant group on the card, as
    autograd of ``ref.py``'s composition gives it: ``(dx, dws, dbs)``,
    dx None unless ``need_dx``. Recomputes each layer's forward, its
    pool winners and gates (``scb_conv_kernel<FWD>``), then per layer in
    reverse dx (``<DX>``) and dW's partial sums (``scb_dw_kernel``), and
    sums the partials of every layer in one ``scb_reduce_kernel``. Raises
    on what the kernels do not take."""
    layers, weights, biases = tuple(layers), tuple(weights), tuple(biases)
    if not 1 <= len(layers) <= MAX_PYRAMID_LAYERS:
        raise ValueError(
            f"stream-conv backward takes 1 to {MAX_PYRAMID_LAYERS} layers, got {len(layers)}")
    for name, t in (("x", x), ("g", g), *((f"weights[{i}]", w) for i, w in enumerate(weights)),
                    *((f"biases[{i}]", b) for i, b in enumerate(biases))):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    b_, h, w, c = x.shape
    geom = group_geometry(h, w, c, layers, tuple(wt.shape[0] for wt in weights),
                          tuple(wt.shape[3] for wt in weights))
    check_bwd_operands(x, weights, biases, g, geom)
    if b_ > 65535:
        raise ValueError(f"batch {b_} above the grid's 65535 images")
    plan = bwd_plan(geom, b_, sm_count(x.device), need_dx)
    lib = _bwd_library()
    dev = x.device
    layer_descs = []
    for lp, bits in zip(plan, act_bits):
        q = _quant_fields(bits)
        layer_descs.append(_ScbLayer(**lp.frame, **q, qlo=q["qmin"] * q["qscale"],
                                     qhi=q["qmax"] * q["qscale"]))

    def launched(name, smem, err):
        _raise_on(err, name)
        LAUNCHES[name] += 1
        probe.launched(name, smem, stream)

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ins, gates, idxs = [x], [], []
        for i, (lp, lg) in enumerate(zip(plan, geom.layers)):
            shape = (b_, lg.out_rows, lg.out_cols, lg.n_out)
            out = torch.empty(shape, device=dev) if i + 1 < len(plan) else None
            gates.append(torch.empty(shape, device=dev))
            idxs.append(torch.empty(shape, device=dev, dtype=torch.uint8))
            r = lp.recompute
            desc = _ScbConv(
                L=layer_descs[i], x=ins[-1].data_ptr(), w=weights[i].data_ptr(),
                b=biases[i].data_ptr(), out=0 if out is None else out.data_ptr(),
                gate_out=gates[-1].data_ptr(), idx_out=idxs[-1].data_ptr(),
                **{f: r[f] for f in ("rows", "n_rb", "cs", "rs", "np", "ys", "tap_off",
                                     "wst_off", "y_off", "threads", "wpt", "tn", "kc")})
            launched("stream_conv_bwd_recompute", r["smem"],
                     lib.scb_conv_launch(0, ctypes.addressof(desc), r["smem"], stream))
            ins.append(out)
        gy, dws, dbs, parts = g, [None] * len(plan), [None] * len(plan), [None] * len(plan)
        dx = None
        for i in reversed(range(len(plan))):
            lp, lg = plan[i], geom.layers[i]
            dx = None
            if lp.dx is not None:
                r = lp.dx
                dx = torch.empty((b_, lg.in_rows, lg.in_cols, lg.in_ch), device=dev)
                desc = _ScbConv(
                    L=layer_descs[i], w=weights[i].data_ptr(), b=biases[i].data_ptr(),
                    g=gy.data_ptr(), gate=gates[i].data_ptr(), idx=idxs[i].data_ptr(),
                    out=dx.data_ptr(),
                    **{f: r[f] for f in ("rows", "n_rb", "cs", "rs", "np", "ys", "tap_off",
                                         "wst_off", "y_off", "threads", "wpt", "tn", "kc")})
                launched("stream_conv_bwd_dx", r["smem"],
                         lib.scb_conv_launch(1, ctypes.addressof(desc), r["smem"], stream))
            d = lp.dw
            parts[i] = torch.empty((d["parts"], d["kk1"], lg.n_out), device=dev)
            desc = _ScbGrad(
                L=layer_descs[i], x=ins[i].data_ptr(), g=gy.data_ptr(),
                gate=gates[i].data_ptr(), idx=idxs[i].data_ptr(), part=parts[i].data_ptr(),
                **{f: d[f] for f in ("rows", "n_rb", "units", "parts", "cs", "rs", "np",
                                     "dz_off", "kth", "ng", "threads", "tk", "tn")})
            launched("stream_conv_bwd_dw", d["smem"],
                     lib.scb_dw_launch(ctypes.addressof(desc), d["ktiles"], d["smem"], stream))
            dws[i] = torch.empty_like(weights[i])
            dbs[i] = torch.empty_like(biases[i])
            gy = dx
        red = _ScbReduce(layers=len(plan))
        for i, lp in enumerate(plan):
            red.part[i], red.dw[i], red.db[i] = (parts[i].data_ptr(), dws[i].data_ptr(),
                                                 dbs[i].data_ptr())
            red.kk1[i], red.n[i], red.parts[i] = lp.dw["kk1"], geom.layers[i].n_out, lp.dw["parts"]
        total = max(lp.dw["kk1"] * lg.n_out for lp, lg in zip(plan, geom.layers))
        launched("stream_conv_bwd_reduce", 0,
                 lib.scb_reduce_launch(ctypes.addressof(red), total, stream))
    return (dx if need_dx else None), tuple(dws), tuple(dbs)
