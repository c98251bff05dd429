"""ctypes wrappers of the hand-written Hopper streaming conv kernels
(``csrc/stream_conv.cu``).

``stream_conv_fused_cuda`` replaces the reference's single-layer Pallas
kernel (``repro/kernels/stream_conv/conv.py:stream_conv_fused_pallas``):
one CTA per (row block, image) over a host-SAME-padded frame, fused
bias -> act -> pool -> quant epilogue. ``stream_conv_pyramid_cuda``
replaces the cross-layer pyramid (``stream_conv_pyramid_pallas``): one CTA
per (row block, image) streams a whole fusion group with every
inter-layer slab in shared memory. The design notes and bounds of both
kernels are in the source.

Each wrapper checks device, dtype, shape and contiguity, allocates its
output with ``torch.empty``, launches on PyTorch's current stream and
raises if the launch is refused. ``LAUNCHES`` counts the launches of each
kernel; nothing else touches the counts. The plain versions of both
kernels are in ``ref.py``; ``ops.py`` picks between them by the device of
the input tensor.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _nvcc
from repro_torch.kernels.padding import round_up
from repro_torch.kernels.stream_conv.epilogue import (
    normalize_pool,
    pool_out_dim,
    stream_quant_spec,
)

# Shared memory one block may use on Hopper (227 KB of the SM's 256 KB).
SMEM_LIMIT = 232_448
MAX_PYRAMID_LAYERS = 4  # SC_MAX_LAYERS in the source
POOL_WINDOWS = (0, 2, 3)  # pool windows the kernels are instantiated for
ACT_CODES = {"none": 0, "relu": 1, "tanh": 2}

LAUNCHES = {"stream_conv_fused": 0, "stream_conv_pyramid": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    ]


class _ScPyramid(ctypes.Structure):
    _fields_ = [
        ("x", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("batch", ctypes.c_int), ("n_layers", ctypes.c_int),
        ("n_rb", ctypes.c_int), ("block_rows", ctypes.c_int),
        ("out_rows", ctypes.c_int),
        ("buf_floats0", ctypes.c_int),
        ("L", _ScLayer * MAX_PYRAMID_LAYERS),
    ]


class _ScFused(ctypes.Structure):
    _fields_ = [
        ("x", ctypes.c_void_p), ("w", ctypes.c_void_p),
        ("b", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("batch", ctypes.c_int), ("h", ctypes.c_int), ("w_in", ctypes.c_int),
        ("c", ctypes.c_int), ("n", ctypes.c_int), ("k", ctypes.c_int),
        ("stride", ctypes.c_int), ("act", ctypes.c_int), ("pw", ctypes.c_int),
        ("ps", ctypes.c_int), ("qbits", ctypes.c_int),
        ("qscale", ctypes.c_float), ("qmin", ctypes.c_float),
        ("qmax", ctypes.c_float),
        ("h_keep", ctypes.c_int), ("w_keep", ctypes.c_int), ("r", ctypes.c_int),
        ("r_o", ctypes.c_int), ("in_rows_blk", ctypes.c_int),
        ("n_rb", ctypes.c_int),
    ]


def _library() -> ctypes.CDLL:
    lib = _nvcc.load("stream_conv")
    if not getattr(lib, "_sc_checked", False):
        for fn in (lib.sc_pyramid_desc_bytes, lib.sc_fused_desc_bytes):
            fn.argtypes, fn.restype = [], ctypes.c_int
        for fn in (lib.sc_pyramid_launch, lib.sc_fused_launch):
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


def _check_pool(pw: int) -> None:
    if pw not in POOL_WINDOWS:
        raise NotImplementedError(
            f"the CUDA kernels are built for pool windows {POOL_WINDOWS}, "
            f"got {pw}"
        )


def _check_f32_cuda(name: str, t: torch.Tensor, shape=None) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


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
                   pool: int, pool_stride, block_r: int) -> dict:
    """Row blocking of the single-layer kernel over an already padded
    (h, wd, c) frame: conv rows per block ``r`` (a multiple of
    ``_block_multiple``), pooled rows per block ``r_o``, input rows per
    block (with the halo) and the block's shared-memory bytes. Halves the
    block toward the multiple until the slab fits; raises if even that
    does not."""
    pw, ps = normalize_pool(pool, pool_stride)
    s = stride
    h_out, w_out = (h - k) // s + 1, (wd - k) // s + 1
    mult, _, overlap = _block_multiple(k, s, pw, ps)
    r = round_up(max(block_r, mult), mult)
    r = min(r, round_up(h_out, mult))
    while True:
        in_rows = (r + overlap - 1) * s + k
        smem = in_rows * wd * c * 4
        if smem <= SMEM_LIMIT or r == mult:
            break
        r = max(mult, round_up(r // 2, mult))
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"single-layer block of {r} conv rows needs {smem} B of shared "
            f"memory, above the {SMEM_LIMIT} B a Hopper block may use"
        )
    h_keep = pool_out_dim(h_out, pw, ps) if pw else h_out
    w_keep = pool_out_dim(w_out, pw, ps) if pw else w_out
    r_o = r // ps if pw else r
    return dict(
        r=r, r_o=r_o, in_rows_blk=in_rows, h_keep=h_keep, w_keep=w_keep,
        n_rb=-(-h_keep // r_o), smem=smem,
    )


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
    block_r: int = 8,
) -> torch.Tensor:
    """Fused streaming conv on the card: VALID conv of stride ``stride``
    over the padded frame, then bias -> act -> pool -> quant. Returns
    (B, H', W', N) with H', W' the pooled output dims."""
    b_, h, wd, c = x.shape
    k, n = w.shape[0], w.shape[3]
    _check_f32_cuda("x", x)
    _check_f32_cuda("w", w, (k, k, c, n))
    _check_f32_cuda("bias", bias, (n,))
    pw, ps = normalize_pool(pool, pool_stride)
    _check_pool(pw)
    if b_ > 65535:
        raise ValueError(f"batch {b_} above the grid's 65535 images")
    g = fused_geometry(h, wd, c, k=k, stride=stride, pool=pool,
                       pool_stride=pool_stride, block_r=block_r)
    out = torch.empty((b_, g["h_keep"], g["w_keep"], n), device=x.device,
                      dtype=torch.float32)
    desc = _ScFused(
        x=x.data_ptr(), w=w.data_ptr(), b=bias.data_ptr(), out=out.data_ptr(),
        batch=b_, h=h, w_in=wd, c=c, n=n, k=k, stride=stride,
        act=ACT_CODES[act], pw=pw or 1, ps=ps or 1, **_quant_fields(act_bits),
        h_keep=g["h_keep"], w_keep=g["w_keep"], r=g["r"], r_o=g["r_o"],
        in_rows_blk=g["in_rows_blk"], n_rb=g["n_rb"],
    )
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sc_fused_launch(ctypes.addressof(desc), g["smem"], stream)
    _raise_on(err, "stream_conv_fused")
    LAUNCHES["stream_conv_fused"] += 1
    return out


# ---------------------------------------------------------------------------
# Cross-layer fused pyramid.


def pyramid_buffers(geom) -> tuple:
    """Floats of the two ping-pong slab buffers: buffer i % 2 holds layer
    i's column-padded input slab (layer 0's read from the frame, later
    ones written by the previous layer's epilogue)."""
    bufs = [0, 0]
    for i, g in enumerate(geom.layers):
        cols = g.in_cols + g.pads[1][0] + g.pads[1][1]
        bufs[i % 2] = max(bufs[i % 2], g.in_slab_rows * cols * g.in_ch)
    return tuple(bufs)


def pyramid_smem_bytes(geom) -> int:
    """Shared memory one pyramid block needs for this group geometry."""
    return 4 * sum(pyramid_buffers(geom))


def stream_conv_pyramid_cuda(
    x: torch.Tensor,  # (B, H, W, C0), unpadded
    weights,  # per layer (K, K, C, N) HWIO
    biases,  # per layer (N,)
    *,
    geom,  # halo.GroupGeometry of the group
    act_bits: tuple,  # per layer int | None
) -> torch.Tensor:
    """Cross-layer fused conv pyramid on the card: the whole group in one
    launch. Returns the group output (B, H', W', N_last)."""
    n_layers = len(geom.layers)
    if n_layers > MAX_PYRAMID_LAYERS:
        raise NotImplementedError(
            f"the pyramid kernel takes up to {MAX_PYRAMID_LAYERS} layers, "
            f"got {n_layers}"
        )
    g0 = geom.layers[0]
    b_ = x.shape[0]
    _check_f32_cuda("x", x, (b_, g0.in_rows, g0.in_cols, g0.in_ch))
    if b_ > 65535:
        raise ValueError(f"batch {b_} above the grid's 65535 images")
    smem = pyramid_smem_bytes(geom)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"pyramid block needs {smem} B of shared memory, above the "
            f"{SMEM_LIMIT} B a Hopper block may use (block_rows="
            f"{geom.block_rows})"
        )
    layer_descs = []
    for i, (g, w, b) in enumerate(zip(geom.layers, weights, biases)):
        _check_f32_cuda(f"weights[{i}]", w, (g.k, g.k, g.in_ch, g.n_out))
        _check_f32_cuda(f"biases[{i}]", b, (g.n_out,))
        _check_pool(g.pw)
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
            )
        )
    last = geom.layers[-1]
    out = torch.empty((b_, geom.out_rows, geom.out_cols, last.n_out),
                      device=x.device, dtype=torch.float32)
    desc = _ScPyramid(
        x=x.data_ptr(), out=out.data_ptr(), batch=b_, n_layers=n_layers,
        n_rb=geom.n_row_blocks, block_rows=geom.block_rows,
        out_rows=geom.out_rows, buf_floats0=pyramid_buffers(geom)[0],
    )
    for i, d in enumerate(layer_descs):
        desc.L[i] = d
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sc_pyramid_launch(ctypes.addressof(desc), smem, stream)
    _raise_on(err, "stream_conv_pyramid")
    LAUNCHES["stream_conv_pyramid"] += 1
    return out
