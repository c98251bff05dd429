"""Public wrapper for the fused selective scan.

The reference picks a path with a ``backend=`` enum; the port dispatches
on the device of ``x``: a CUDA tensor goes to the hand-written kernel
(``scan.py``) and the call raises if the kernel cannot take it; a CPU
tensor goes to the plain PyTorch version (``ref.py``). There is no other
path and no fallback between the two.

A call that autograd must see through (grad mode on, and an input
requiring grad) goes through :class:`_ScanGrad`: its forward is the same
dispatch, so the loss comes from the kernel's output; its backward
recomputes the reference's training math (``ref.ssm_scan_chunked_ref``)
from the saved inputs and differentiates it, the counterpart of XLA's
autodiff of the reference's ``mamba_apply`` (the JAX package has no
backward kernel). Every other call, inference included, is the bare
dispatch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.backends import backward_numerics, on_cuda
from repro_torch.kernels.ssm_scan import ref as _ref
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.kernels.ssm_scan.scan import ssm_scan_cuda


def _dispatch(x, dt, b, c, a, d_skip, h0):
    if not on_cuda(x):
        return ssm_scan_ref(x, dt, b, c, a, d_skip, h0)
    return ssm_scan_cuda(x, dt, b, c, a, d_skip, h0)


class _ScanGrad(torch.autograd.Function):
    """The selective scan with a gradient.

    The forward is the wrapper's dispatch: the kernel on a CUDA tensor,
    the step loop on a CPU one. The backward recomputes
    ``ref.ssm_scan_chunked_ref`` (the discretized (Bz, S, D, N) tensors,
    ``chunked_linear_recurrence``, the contraction with C, ``D x``) from
    the saved inputs under autograd and returns ``torch.autograd.grad``
    of it, on the card under ``backward_numerics`` (TF32 off). It calls
    ``ref.py`` directly, so the dispatch's plain version never runs on the
    card. A gradient left undefined for ``h_last`` (training reads ``y``
    alone) is skipped; bf16 ``x``, B and C get bf16 gradients."""

    @staticmethod
    def forward(ctx, x, dt, b, c, a, d_skip, h0):
        ctx.set_materialize_grads(False)
        ctx.has_h0 = h0 is not None
        ctx.save_for_backward(x, dt, b, c, a, d_skip, *((h0,) if ctx.has_h0 else ()))
        return _dispatch(x, dt, b, c, a, d_skip, h0)

    @staticmethod
    def backward(ctx, g_y, g_h):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[: len(saved)]
        pairs = [(out_g, i) for i, out_g in enumerate((g_y, g_h)) if out_g is not None]
        if not pairs or not any(need):
            return (None,) * 7
        with torch.enable_grad(), backward_numerics(saved[0]):
            leaves = [t.detach().requires_grad_(r) for t, r in zip(saved, need)]
            outs = _ref.ssm_scan_chunked_ref(*leaves[:6], leaves[6] if ctx.has_h0 else None)
            grads = iter(torch.autograd.grad(
                [outs[i] for _, i in pairs], [t for t, r in zip(leaves, need) if r],
                [g for g, _ in pairs], allow_unused=True,
            ))
        out = [next(grads) if r else None for r in need]
        return (*out, *((None,) * (7 - len(out))))


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
    inputs = (x, dt, b, c, a, d_skip, h0)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        return _ScanGrad.apply(*inputs)
    return _dispatch(*inputs)
