"""Public wrapper for the fused selective scan.

The reference picks a path with a ``backend=`` enum; the port dispatches
on the device of ``x``: a CUDA tensor goes to the hand-written kernel
(``scan.py``) and the call raises if the kernel cannot take it; a CPU
tensor goes to the plain PyTorch version (``ref.py``). There is no other
path and no fallback between the two.
"""
from __future__ import annotations

from repro_torch.kernels.backends import on_cuda
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.kernels.ssm_scan.scan import ssm_scan_cuda


def ssm_scan(x, dt, b, c, a, d_skip, h0=None, *, block_d: int = 256):
    """Fused Mamba-1 selective scan: y_t = (h_t . C_t) + D*x_t with
    h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t, the state starting at
    ``h0`` (zeros when None). Returns (y (Bz, S, D) f32, h_last
    (Bz, D, N) f32); the reference's ``ssm_scan`` returns y alone and has
    no initial state. ``block_d`` is the reference's channel block; the
    plain version has none, and on the card ``scan.scan_plan`` lays the
    channels out (the kernel masks a ragged D), so it is not read."""
    bz, s, di = x.shape
    n = b.shape[-1]
    if dt.shape != x.shape:
        raise ValueError(f"dt {tuple(dt.shape)} must match x {tuple(x.shape)}")
    if b.shape != (bz, s, n) or c.shape != (bz, s, n):
        raise ValueError(
            f"b {tuple(b.shape)} and c {tuple(c.shape)} must be {(bz, s, n)}"
        )
    if a.shape != (di, n) or d_skip.shape != (di,):
        raise ValueError(
            f"a {tuple(a.shape)} / d_skip {tuple(d_skip.shape)} must be "
            f"{(di, n)} / {(di,)}"
        )
    if h0 is not None and h0.shape != (bz, di, n):
        raise ValueError(f"h0 {tuple(h0.shape)} must be {(bz, di, n)}")
    if not on_cuda(x):
        return ssm_scan_ref(x, dt, b, c, a, d_skip, h0)
    return ssm_scan_cuda(x, dt, b, c, a, d_skip, h0)
