"""ctypes wrappers of the hand-written Hopper selective scan
(``csrc/ssm_scan.cu``) and of its gradient (``csrc/ssm_scan_bwd.cu``).

``ssm_scan_cuda`` replaces the reference's Pallas kernel
(``repro/kernels/ssm_scan/scan.py:ssm_scan_pallas``) and adds what the
reference's ``mamba_apply`` needs from the recurrence: an initial state
``h0`` and the final state ``h_last``. The design notes and bound are in
the source. ``scan_plan`` (plain Python, tested on the CPU) picks the
lanes each channel's states are split over, the steps staged per chunk
and the channels per CTA, from the shape and the card's SM count.

The wrapper checks device, dtype, shape and strides, allocates ``y`` and
``h_last`` with ``torch.empty``, launches on PyTorch's current stream and
raises if the launch is refused. x, B and C are read in their own dtype
(bfloat16 or float32, the same for all three) and may be strided views
with a unit last stride, as ``mamba_apply``'s slices of one projection
are; no cast or copy pass runs before the launch. ``LAUNCHES`` counts the
launches (registered with ``kernels/probe.py``, so a CUDA graph of the
decode step adjusts the count: ``probe.uncount`` at its capture,
``probe.replayed`` at each replay); nothing else touches the count. Each
launch is also logged on the calling thread's probe log, with the shared
memory of its plan. The plain version is
``ref.py``; ``ops.py`` picks between them by the device of the input.

``ssm_scan_bwd_cuda`` is the scan's gradient on the card (no Pallas
kernel: the reference differentiates its composition with XLA), laid out
by ``scan_bwd_plan``: the forward's lanes and channels per CTA, and the
steps a checkpoint covers. It is checked as the forward is, allocates the
gradients and one workspace (the chunks' checkpointed states and the
partial sums the second kernel adds up in a fixed order) and counts its
launches under ``LAUNCHES["ssm_scan_bwd"]``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _nvcc, probe
from repro_torch.kernels.backends import sm_count
from repro_torch.kernels.padding import round_up

MAX_NPL = 32  # SSM_MAX_NPL in the source: states a lane keeps in registers
MAX_LANES = 16  # a step group of L steps is staged whole: 16 keeps it in a block
MAX_N = MAX_NPL * MAX_LANES
MAX_GRID_Y = 65535  # batch rows
IN_DTYPES = {torch.bfloat16: 1, torch.float32: 0}
# The lane counts a channel's states may be split over, fewest first: the
# plan takes the fewest whose grid gives every SM FILL_WARPS_PER_SM warps
# (fewer lanes, fewer instructions a state; more lanes, more warps to hide
# latency: PERF.md, the H100's times at 1, 2, 4, 8 and 16 lanes).
LANE_CHOICES = (2, 4, 8, 16)
FILL_WARPS_PER_SM = 12
# (lanes, states a lane) kernels compiled in the source (SSM_TILES): what
# scan_plan picks for any N up to MAX_N.
KERNEL_TILES = frozenset({
    (1, 1), (2, 1), (2, 2), (2, 8), (4, 1), (4, 2), (4, 4), (4, 8), (4, 16), (4, 32),
    (8, 2), (8, 32), (16, 1), (16, 32)})
THREADS = 128  # per CTA, or 8 channels' lanes where L > 16
MAX_CHUNK = 64  # steps staged per chunk
SM_THREADS, SM_CTAS = 2048, 32  # per SM on Hopper
SM_SMEM = 233_472  # shared memory per SM (228 KB)
BLOCK_SMEM = 232_448  # of which one block may use
CTA_RESERVED_SMEM = 1024  # of which CUDA reserves 1 KB per resident CTA

# The backward: steps a checkpoint covers, a power of two up to
# BWD_MAX_CHUNK; fewer CTAs an SM rather than fewer than BWD_MIN_CHUNK
# steps, which would grow the checkpoints (1 / chunk of the states).
BWD_MAX_CHUNK, BWD_MIN_CHUNK = 32, 16

LAUNCHES = probe.counted({"ssm_scan": 0, "ssm_scan_bwd": 0})


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
        ("n", ctypes.c_int), ("lanes", ctypes.c_int), ("chunk", ctypes.c_int),
        ("dc", ctypes.c_int), ("bcp", ctypes.c_int), ("vec", ctypes.c_int),
        ("bf16", ctypes.c_int),
    ]


def _pow2_at_least(v: int) -> int:
    p = 1
    while p < v:
        p *= 2
    return p


def _pow2_at_most(v: int) -> int:
    p = 1
    while 2 * p <= v:
        p *= 2
    return p


def y_pitch(dc: int, lanes: int) -> int:
    """Floats per staged y row (``ssm_y_pitch`` in the source): DC plus a
    pad that puts the steps a channel's lanes store at once on distinct
    banks, a multiple of 4."""
    return dc + max(4, 32 // lanes)


def smem_bytes(chunk: int, dc: int, bcp: int, elem_bytes: int, lanes: int) -> int:
    """Shared memory of one CTA (``ssm_smem_bytes`` in the source): x and
    dt, B and C (as f32) and y, each double-buffered over ``chunk``
    steps."""
    return 2 * chunk * (dc * elem_bytes + dc * 4 + 2 * bcp * 4 + y_pitch(dc, lanes) * 4)


@functools.lru_cache(maxsize=256)
def scan_plan(bz: int, s: int, d: int, n: int, *, n_sms: int, elem_bytes: int = 2) -> dict:
    """How the kernel covers a (Bz, S, D) scan of N states on a card of
    ``n_sms`` SMs: each channel's states split over ``lanes`` lanes
    (``npl`` states a lane, a power of two; ``lanes * npl >= n``, the rest
    zero-padded), ``dc`` channels and ``threads`` threads per CTA, a grid
    of ``ctas`` CTAs, ``chunk`` steps staged per chunk, ``bcp`` elements
    per staged (f32) B / C row and the CTA's shared-memory bytes.

    The lanes are the fewest of LANE_CHOICES (at most N, with a compiled
    kernel) whose grid gives the card FILL_WARPS_PER_SM warps an SM, else
    the most of them; one where N is 1. ``chunk`` is the largest
    power of two up to MAX_CHUNK (and S, but at least ``lanes``: the
    kernel steps ``lanes`` steps at a time) at which the CTAs that fall on
    one SM fit its shared memory. Raises where N is above MAX_N."""
    if n > MAX_N:
        raise ValueError(f"the kernel keeps at most {MAX_N} states a channel, got N={n}")
    fits = [L for L in LANE_CHOICES
            if L <= n and (L, _pow2_at_least(-(-n // L))) in KERNEL_TILES]
    lanes = next((L for L in fits if bz * d * L >= n_sms * FILL_WARPS_PER_SM * 32),
                 fits[-1] if fits else 1)
    npl = _pow2_at_least(-(-n // lanes))
    threads = max(THREADS, 8 * lanes)
    dc = threads // lanes
    ctas = bz * -(-d // dc)
    per_sm = min(-(-ctas // n_sms), SM_THREADS // threads, SM_CTAS)
    bcp = round_up(lanes * npl, 4)
    def fits_smem(ch):
        b = smem_bytes(ch, dc, bcp, elem_bytes, lanes)
        return b <= BLOCK_SMEM and per_sm * (b + CTA_RESERVED_SMEM) <= SM_SMEM

    chunk = max(lanes, min(MAX_CHUNK, _pow2_at_least(s)))
    while chunk > lanes and not fits_smem(chunk):
        chunk //= 2
    if smem_bytes(chunk, dc, bcp, elem_bytes, lanes) > BLOCK_SMEM:
        raise ValueError(f"a chunk of {chunk} steps of N={n} needs more shared memory "
                         f"than a block's {BLOCK_SMEM} B")
    return dict(lanes=lanes, npl=npl, dc=dc, threads=threads, ctas=ctas, chunk=chunk,
                bcp=bcp, smem=smem_bytes(chunk, dc, bcp, elem_bytes, lanes), per_sm=per_sm,
                warps=ctas * threads // 32)


def bwd_smem_bytes(chunk: int, dc: int, lanes: int, npl: int, bcp: int, elem_bytes: int) -> int:
    """Shared memory of one backward CTA (``ssmb_smem_bytes`` in the
    source), per step: the chunk's recomputed states (``lanes * npl`` a
    channel), dt, g_y, dx and ddt (f32 a channel), B and C (f32 rows of
    ``bcp``), each warp's dB and dC sums, and x in its own dtype."""
    warps = dc * lanes // 32
    return chunk * (4 * (dc * lanes * npl + 4 * dc + 2 * bcp + warps * 2 * bcp) + dc * elem_bytes)


@functools.lru_cache(maxsize=256)
def scan_bwd_plan(bz: int, s: int, d: int, n: int, *, n_sms: int, elem_bytes: int = 2) -> dict:
    """How the backward kernel covers a (Bz, S, D) scan of N states: the
    forward's ``lanes``, ``npl``, ``dc``, ``threads`` and ``bcp``
    (``scan_plan``), and ``chunk``, the steps a checkpoint covers and the
    CTA stages at once: the largest power of two up to BWD_MAX_CHUNK (and
    S) at which the forward's CTAs an SM fit its shared memory, but not
    below BWD_MIN_CHUNK where one block fits (then fewer CTAs an SM,
    ``per_sm``), and below it only as far as one block needs. Also the
    CTA's shared-memory bytes, the channel blocks
    ``nblk``, the checkpoints a row keeps (``n_ckpt``) and the
    workspace's f32 elements: the checkpoints (Bz x n_ckpt x D x
    lanes * npl), each block's dB and dC (Bz x nblk x S x 2N), each row's
    dA (Bz x D x N) and dD (Bz x D), each piece padded to 4. Raises where
    N is above MAX_N or one step of a CTA does not fit a block."""
    fwd = scan_plan(bz, s, d, n, n_sms=n_sms, elem_bytes=elem_bytes)
    lanes, npl, dc, bcp = (fwd[k] for k in ("lanes", "npl", "dc", "bcp"))

    def smem(ch):
        return bwd_smem_bytes(ch, dc, lanes, npl, bcp, elem_bytes)

    def resident(ch):
        return min(fwd["per_sm"], SM_SMEM // (smem(ch) + CTA_RESERVED_SMEM))

    top = min(BWD_MAX_CHUNK, _pow2_at_least(s))
    chunk = top
    while chunk > min(BWD_MIN_CHUNK, top) and resident(chunk) < fwd["per_sm"]:
        chunk //= 2
    while chunk > 1 and smem(chunk) > BLOCK_SMEM:
        chunk //= 2
    if smem(chunk) > BLOCK_SMEM:
        raise ValueError(f"a backward step of N={n} needs more shared memory than a block's "
                         f"{BLOCK_SMEM} B")
    n_ckpt, nblk = -(-s // chunk), -(-d // dc)
    parts = [bz * n_ckpt * d * lanes * npl, bz * nblk * s * 2 * n, bz * d * n, bz * d]
    return dict(lanes=lanes, npl=npl, dc=dc, threads=fwd["threads"], chunk=chunk, bcp=bcp,
                smem=smem(chunk), per_sm=resident(chunk), nblk=nblk, n_ckpt=n_ckpt,
                parts=tuple(parts), workspace=sum(round_up(v, 4) for v in parts))


def _library() -> ctypes.CDLL:
    lib = _nvcc.load("ssm_scan")
    if not getattr(lib, "_ssm_checked", False):
        for fn in (lib.ssm_desc_bytes, lib.ssm_max_npl):
            fn.argtypes, fn.restype = [], ctypes.c_int
        if lib.ssm_max_npl() != MAX_NPL:
            raise RuntimeError(f"the library keeps {lib.ssm_max_npl()} states a lane, "
                               f"Python {MAX_NPL}")
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


def _rows_16b(t: torch.Tensor, whole: bool = False) -> bool:
    """Whether the kernel may stage rows of ``t`` (batch and step strides,
    unit last stride) 16 bytes at a time: every row starts 16-byte
    aligned and, where ``whole``, holds whole 16-byte groups."""
    e = t.element_size()
    return (t.data_ptr() % 16 == 0 and all(t.stride(i) * e % 16 == 0 for i in (0, 1))
            and not (whole and t.shape[-1] * e % 16))


def ssm_scan_cuda(
    x: torch.Tensor,  # (Bz, S, D) bf16 or f32
    dt: torch.Tensor,  # (Bz, S, D) f32
    b: torch.Tensor,  # (Bz, S, N) x's dtype
    c: torch.Tensor,  # (Bz, S, N) x's dtype
    a: torch.Tensor,  # (D, N) f32
    d_skip: torch.Tensor,  # (D,) f32
    h0: torch.Tensor | None = None,  # (Bz, D, N) f32
) -> tuple:
    """The selective scan on the card, laid out by ``scan_plan``. Returns
    (y (Bz, S, D) f32, h_last (Bz, D, N) f32)."""
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
    if bz > MAX_GRID_Y:
        raise ValueError(f"batch {bz} above the grid's {MAX_GRID_Y} rows")
    plan = scan_plan(bz, s, di, n, n_sms=sm_count(x.device), elem_bytes=x.element_size())
    y = torch.empty((bz, s, di), device=x.device, dtype=torch.float32)
    h_last = torch.empty((bz, di, n), device=x.device, dtype=torch.float32)
    states_16b = a.data_ptr() % 16 == 0 and (h0 is None or h0.data_ptr() % 16 == 0)
    vec = (_rows_16b(x) | _rows_16b(dt) << 1 | _rows_16b(b, whole=True) << 2
           | _rows_16b(c, whole=True) << 3 | states_16b << 4)
    desc = _SsmScan(
        x=x.data_ptr(), dt=dt.data_ptr(), b=b.data_ptr(), c=c.data_ptr(),
        a=a.data_ptr(), d_skip=d_skip.data_ptr(),
        h0=None if h0 is None else h0.data_ptr(), y=y.data_ptr(),
        h_last=h_last.data_ptr(),
        x_sb=x.stride(0), x_ss=x.stride(1), dt_sb=dt.stride(0), dt_ss=dt.stride(1),
        b_sb=b.stride(0), b_ss=b.stride(1), c_sb=c.stride(0), c_ss=c.stride(1),
        bz=bz, s=s, d=di, n=n, lanes=plan["lanes"], chunk=plan["chunk"], dc=plan["dc"],
        bcp=plan["bcp"], vec=vec, bf16=IN_DTYPES[x.dtype],
    )
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssm_scan_launch(ctypes.addressof(desc), stream)
    if err:
        raise RuntimeError(f"ssm_scan launch failed: CUDA error {err}")
    LAUNCHES["ssm_scan"] += 1
    probe.launched("ssm_scan", plan["smem"], stream)
    return y, h_last


class _SsmScanBwd(ctypes.Structure):
    _fields_ = [
        ("x", ctypes.c_void_p), ("dt", ctypes.c_void_p),
        ("b", ctypes.c_void_p), ("c", ctypes.c_void_p),
        ("a", ctypes.c_void_p), ("d_skip", ctypes.c_void_p),
        ("h0", ctypes.c_void_p), ("g_y", ctypes.c_void_p), ("g_h", ctypes.c_void_p),
        ("grad_x", ctypes.c_void_p), ("grad_dt", ctypes.c_void_p),
        ("grad_b", ctypes.c_void_p), ("grad_c", ctypes.c_void_p),
        ("grad_a", ctypes.c_void_p), ("grad_d", ctypes.c_void_p),
        ("grad_h0", ctypes.c_void_p),
        ("ckpt", ctypes.c_void_p), ("ws_bc", ctypes.c_void_p),
        ("ws_a", ctypes.c_void_p), ("ws_d", ctypes.c_void_p),
        ("x_sb", ctypes.c_longlong), ("x_ss", ctypes.c_longlong),
        ("dt_sb", ctypes.c_longlong), ("dt_ss", ctypes.c_longlong),
        ("b_sb", ctypes.c_longlong), ("b_ss", ctypes.c_longlong),
        ("c_sb", ctypes.c_longlong), ("c_ss", ctypes.c_longlong),
        ("gy_sb", ctypes.c_longlong), ("gy_ss", ctypes.c_longlong),
        ("bz", ctypes.c_int), ("s", ctypes.c_int), ("d", ctypes.c_int),
        ("n", ctypes.c_int), ("lanes", ctypes.c_int), ("chunk", ctypes.c_int),
        ("dc", ctypes.c_int), ("bcp", ctypes.c_int), ("bf16", ctypes.c_int),
    ]


def _bwd_library() -> ctypes.CDLL:
    lib = _nvcc.load("ssm_scan_bwd")
    if not getattr(lib, "_ssm_bwd_checked", False):
        for fn in (lib.ssm_bwd_desc_bytes, lib.ssm_bwd_max_npl):
            fn.argtypes, fn.restype = [], ctypes.c_int
        lib.ssm_bwd_smem_bytes.argtypes = [ctypes.c_int] * 6
        lib.ssm_bwd_smem_bytes.restype = ctypes.c_int
        lib.ssm_scan_bwd_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.ssm_scan_bwd_launch.restype = ctypes.c_int
        if lib.ssm_bwd_max_npl() != MAX_NPL:
            raise RuntimeError(f"the backward library keeps {lib.ssm_bwd_max_npl()} states a "
                               f"lane, Python {MAX_NPL}")
        if lib.ssm_bwd_desc_bytes() != ctypes.sizeof(_SsmScanBwd):
            raise RuntimeError(
                f"_SsmScanBwd is {ctypes.sizeof(_SsmScanBwd)} B in Python but "
                f"{lib.ssm_bwd_desc_bytes()} B in the library: the layouts disagree"
            )
        for args in ((8, 64, 2, 8, 16, 2), (3, 8, 16, 32, 512, 4)):
            if lib.ssm_bwd_smem_bytes(*args) != bwd_smem_bytes(*args):
                raise RuntimeError(f"backward shared memory at {args}: library "
                                   f"{lib.ssm_bwd_smem_bytes(*args)} B, Python "
                                   f"{bwd_smem_bytes(*args)} B")
        lib._ssm_bwd_checked = True
    return lib


def ssm_scan_bwd_cuda(
    x: torch.Tensor,  # (Bz, S, D) bf16 or f32
    dt: torch.Tensor,  # (Bz, S, D) f32
    b: torch.Tensor,  # (Bz, S, N) x's dtype
    c: torch.Tensor,  # (Bz, S, N) x's dtype
    a: torch.Tensor,  # (D, N) f32
    d_skip: torch.Tensor,  # (D,) f32
    h0: torch.Tensor | None,  # (Bz, D, N) f32
    g_y: torch.Tensor | None,  # (Bz, S, D) f32: the cotangent of y
    g_h: torch.Tensor | None,  # (Bz, D, N) f32: the cotangent of h_last
) -> tuple:
    """The scan's gradient on the card, laid out by ``scan_bwd_plan``:
    (dx, ddt, dB, dC, dA, dD_skip, dh0), dx, dB and dC in x's dtype, the
    rest f32, all contiguous; dh0 None where ``h0`` is. An absent
    cotangent counts as zeros. One call, one count: the kernel and its
    reduction, launched together."""
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
    if g_y is not None:
        _check("g_y", g_y, torch.float32, (bz, s, di), contiguous=False)
    if g_h is not None:
        _check("g_h", g_h, torch.float32, (bz, di, n))
    if bz > MAX_GRID_Y:
        raise ValueError(f"batch {bz} above the grid's {MAX_GRID_Y} rows")
    if s < 1:
        raise ValueError("the backward needs at least one step")
    plan = scan_bwd_plan(bz, s, di, n, n_sms=sm_count(x.device), elem_bytes=x.element_size())
    dev = x.device
    grads = (torch.empty((bz, s, di), device=dev, dtype=x.dtype),
             torch.empty((bz, s, di), device=dev, dtype=torch.float32),
             torch.empty((bz, s, n), device=dev, dtype=x.dtype),
             torch.empty((bz, s, n), device=dev, dtype=x.dtype),
             torch.empty((di, n), device=dev, dtype=torch.float32),
             torch.empty((di,), device=dev, dtype=torch.float32),
             None if h0 is None else torch.empty((bz, di, n), device=dev, dtype=torch.float32))
    ws = torch.empty((plan["workspace"],), device=dev, dtype=torch.float32)
    offsets, at = [], 0
    for size in plan["parts"]:
        offsets.append(ws.data_ptr() + 4 * at)
        at += round_up(size, 4)

    def ptr(t):
        return None if t is None else t.data_ptr()

    gy_sb, gy_ss = (0, 0) if g_y is None else (g_y.stride(0), g_y.stride(1))
    desc = _SsmScanBwd(
        x=ptr(x), dt=ptr(dt), b=ptr(b), c=ptr(c), a=ptr(a), d_skip=ptr(d_skip), h0=ptr(h0),
        g_y=ptr(g_y), g_h=ptr(g_h),
        grad_x=ptr(grads[0]), grad_dt=ptr(grads[1]), grad_b=ptr(grads[2]), grad_c=ptr(grads[3]),
        grad_a=ptr(grads[4]), grad_d=ptr(grads[5]), grad_h0=ptr(grads[6]),
        ckpt=offsets[0], ws_bc=offsets[1], ws_a=offsets[2], ws_d=offsets[3],
        x_sb=x.stride(0), x_ss=x.stride(1), dt_sb=dt.stride(0), dt_ss=dt.stride(1),
        b_sb=b.stride(0), b_ss=b.stride(1), c_sb=c.stride(0), c_ss=c.stride(1),
        gy_sb=gy_sb, gy_ss=gy_ss,
        bz=bz, s=s, d=di, n=n, lanes=plan["lanes"], chunk=plan["chunk"], dc=plan["dc"],
        bcp=plan["bcp"], bf16=IN_DTYPES[x.dtype],
    )
    lib = _bwd_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssm_scan_bwd_launch(ctypes.addressof(desc), stream)
    if err:
        raise RuntimeError(f"ssm_scan_bwd launch failed: CUDA error {err}")
    LAUNCHES["ssm_scan_bwd"] += 1
    probe.launched("ssm_scan_bwd", plan["smem"], stream)
    return grads
