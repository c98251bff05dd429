"""Public wrapper for the fused selective scan.

The reference picks a path with a ``backend=`` enum; the port dispatches
on the device of ``x`` through one registered op, ``repro_torch::ssm_scan``
(``torch.library.custom_op``): its CUDA implementation is the hand-written
kernel (``scan.py``), which raises if it cannot take the call; its CPU
implementation is the plain PyTorch version (``ref.py``); its fake (meta)
implementation gives the outputs' shapes, so a step runs on the ``meta``
device with the scan as one node, charged 2 Bz S D N FLOPs (the
contraction with C, what the reference's HLO analysis counts for the
composition its model lowers) under ``FlopCounterMode`` and the dry run
(``launch/dryrun.py``). The op is the only place a ``meta`` tensor is
accepted; any other device raises. There is no fallback between paths.

A call that autograd must see through (grad mode on, and an input
requiring grad) goes through :class:`_ScanGrad`: its forward is the same
dispatch, so the loss comes from the kernel's output; its backward is a
second registered op, ``repro_torch::ssm_scan_bwd``, the counterpart of
XLA's autodiff of the reference's ``mamba_apply`` (the JAX package has
no backward kernel): on the card the hand-written reverse-time kernel
(``scan.ssm_scan_bwd_cuda``), on the CPU the plain version, the
vector-Jacobian product of the reference's training math
(``ref.ssm_scan_bwd_ref`` of ``ref.ssm_scan_chunked_ref``). It is one
node of an op log too, charged 2 Bz S D N FLOPs: the states' contraction
with g_y into dC, what the reference's HLO analysis counts for its
autodiff (the forward's einsum and dC's; the outer product g_y x C is a
broadcast there). Every other call, inference included, is the bare
dispatch.
"""
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref, ssm_scan_ref
from repro_torch.kernels.ssm_scan.scan import ssm_scan_bwd_cuda, ssm_scan_cuda


@torch.library.custom_op("repro_torch::ssm_scan", mutates_args=(), device_types="cpu")
def scan_op(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
            a: torch.Tensor, d_skip: torch.Tensor,
            h0: Optional[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """The selective scan as one op: (y (Bz, S, D) f32, h_last (Bz, D, N)
    f32). On the CPU the plain version (this module's ``ssm_scan_ref``,
    looked up at each call, so a test may count its calls)."""
    return ssm_scan_ref(x, dt, b, c, a, d_skip, h0)


@scan_op.register_kernel("cuda")
def _scan_cuda(x, dt, b, c, a, d_skip, h0):
    return ssm_scan_cuda(x, dt, b, c, a, d_skip, h0)


@scan_op.register_fake
def _scan_fake(x, dt, b, c, a, d_skip, h0):
    bz, s, di = x.shape
    return (x.new_empty((bz, s, di), dtype=torch.float32),
            x.new_empty((bz, di, b.shape[-1]), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.ssm_scan)
def scan_flops(x_shape, dt_shape, b_shape, *args, **kwargs) -> int:
    """2 Bz S D N: the states' contraction with C."""
    bz, s, di = x_shape
    return 2 * bz * s * di * b_shape[-1]


@torch.library.custom_op("repro_torch::ssm_scan_bwd", mutates_args=(), device_types="cpu")
def scan_bwd_op(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                a: torch.Tensor, d_skip: torch.Tensor, h0: Optional[torch.Tensor],
                g_y: Optional[torch.Tensor], g_h: Optional[torch.Tensor]
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor, torch.Tensor]:
    """The scan's gradient as one op, given the cotangents of y and
    h_last (either None): (dx, ddt, dB, dC, dA, dD_skip, dh0), contiguous,
    dx, dB and dC in x's dtype, dh0 empty where ``h0`` is None. On the
    CPU the plain version (this module's ``ssm_scan_bwd_ref``, looked up
    at each call, so a test may count its calls), under
    :func:`_autograd_below_the_op`."""
    with _autograd_below_the_op():
        grads = ssm_scan_bwd_ref(x, dt, b, c, a, d_skip, h0, g_y, g_h)
    return tuple(_no_dh0(x) if g is None else g.contiguous() for g in grads)


_AUTOGRAD_KEYS = (torch._C.DispatchKey.AutogradFunctionality, torch._C.DispatchKey.AutogradOther,
                  torch._C.DispatchKey.AutogradNestedTensor, torch._C.DispatchKey.ADInplaceOrView)


def _autograd_below_the_op():
    """The dispatcher runs an op's implementation with autograd's keys
    excluded, so the plain version's ``torch.autograd.grad`` would find
    no graph: this guard takes them out of the thread's excluded set for
    the call and leaves the rest (a dispatch mode that is handling the op,
    such as the dry run's recorder, still does not see the ops inside,
    as it does not see the forward op's)."""
    excluded = torch._C._dispatch_tls_local_exclude_set()
    for key in _AUTOGRAD_KEYS:
        excluded = excluded.remove(key)
    return torch._C._ForceDispatchKeyGuard(torch._C._dispatch_tls_local_include_set(), excluded)


def _no_dh0(x):
    return x.new_empty((0,), dtype=torch.float32)


@scan_bwd_op.register_kernel("cuda")
def _scan_bwd_cuda(x, dt, b, c, a, d_skip, h0, g_y, g_h):
    grads = ssm_scan_bwd_cuda(x, dt, b, c, a, d_skip, h0, g_y, g_h)
    return (*grads[:6], _no_dh0(x) if h0 is None else grads[6])


@scan_bwd_op.register_fake
def _scan_bwd_fake(x, dt, b, c, a, d_skip, h0, g_y, g_h):
    f32 = torch.float32
    return (x.new_empty(x.shape), x.new_empty(dt.shape, dtype=f32), x.new_empty(b.shape),
            x.new_empty(c.shape), x.new_empty(a.shape, dtype=f32),
            x.new_empty(d_skip.shape, dtype=f32),
            _no_dh0(x) if h0 is None else x.new_empty(h0.shape, dtype=f32))


@register_flop_formula(torch.ops.repro_torch.ssm_scan_bwd)
def scan_bwd_flops(x_shape, dt_shape, b_shape, *args, **kwargs) -> int:
    """2 Bz S D N: the states' contraction with g_y into dC."""
    bz, s, di = x_shape
    return 2 * bz * s * di * b_shape[-1]


class _ScanGrad(torch.autograd.Function):
    """The selective scan with a gradient.

    The forward is the wrapper's dispatch: the kernel on a CUDA tensor,
    the step loop on a CPU one. The backward is ``scan_bwd_op`` on the
    saved inputs: the reverse-time kernel on the card, the plain
    version's vector-Jacobian product on the CPU; nothing else runs, so
    the dispatch's plain versions never run on the card. A gradient left
    undefined for ``h_last`` (training reads ``y`` alone) is skipped;
    bf16 ``x``, B and C get bf16 gradients."""

    @staticmethod
    def forward(ctx, x, dt, b, c, a, d_skip, h0):
        ctx.set_materialize_grads(False)
        ctx.has_h0 = h0 is not None
        ctx.save_for_backward(x, dt, b, c, a, d_skip, *((h0,) if ctx.has_h0 else ()))
        return scan_op(x, dt, b, c, a, d_skip, h0)

    @staticmethod
    def backward(ctx, g_y, g_h):
        need = ctx.needs_input_grad
        if (g_y is None and g_h is None) or not any(need):
            return (None,) * 7
        x, dt, b, c, a, d_skip, *h0 = ctx.saved_tensors
        grads = scan_bwd_op(x, dt, b, c, a, d_skip, h0[0] if h0 else None,
                            None if g_y is None else g_y.contiguous(),
                            None if g_h is None else g_h.contiguous())
        return tuple(g if r else None for g, r in zip(grads, need))


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
    return scan_op(*inputs)
