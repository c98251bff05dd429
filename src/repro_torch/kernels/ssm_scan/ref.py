"""Plain PyTorch versions of the fused selective-SSM scan.

Semantics (Mamba-1 inner recurrence, diagonal A), as the reference's
``repro/kernels/ssm_scan/ref.py``:

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) outer B_t
    y_t = (h_t . C_t) + D * x_t

Shapes: x, dt (Bz, S, D); B, C (Bz, S, N); A (D, N); D_skip (D,);
h0 (Bz, D, N) or None (zeros). Everything is computed in float32.
Both return (y (Bz, S, D) f32, h_last (Bz, D, N) f32).

``ssm_scan_ref`` is the dispatch's plain version on the CPU: a step loop
that holds one (Bz, D, N) state, never the (Bz, S, D, N) discretized
tensors. ``ssm_scan_chunked_ref`` is the reference's training math
(``repro.models.ssm.mamba_apply``): the discretized tensors formed in
full, ``chunked_linear_recurrence`` over them, the contraction with C;
nothing dispatches to it. ``ssm_scan_bwd_ref`` differentiates it: the
gradient's plain version, what the backward op runs on the CPU.

``chunked_linear_recurrence`` is the reference's (RG-LRU runs it too,
``models/ssm.py``): inside a chunk ``_associative_scan`` combines
elements in the order ``jax.lax.associative_scan`` does (pairs, then the
odd half recursively, then the even elements), so the f32 states take
the reference's sums (they may differ in the last bits where XLA
contracts a multiply-add); chunks follow in a Python loop carrying the
boundary state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ssm_scan_ref(x, dt, b, c, a, d_skip, h0=None):
    bz, s, di = x.shape
    n = b.shape[-1]
    x, dt, b, c = x.float(), dt.float(), b.float(), c.float()
    a, d_skip = a.float(), d_skip.float()
    h = (torch.zeros((bz, di, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    y = torch.empty((bz, s, di), dtype=torch.float32, device=x.device)
    for t in range(s):
        x_t, dt_t = x[:, t], dt[:, t]  # (Bz, D)
        dta = torch.exp(dt_t[:, :, None] * a)  # (Bz, D, N)
        h = dta * h + (dt_t * x_t)[:, :, None] * b[:, t, None, :]
        y[:, t] = (h * c[:, t, None, :]).sum(dim=-1) + d_skip * x_t
    return y, h


# ---------------------------------------------------------------------------
# Chunked diagonal linear recurrence


def _combine(left, right):
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, a2 * b1 + b2


def _associative_scan(fn, elems, dim: int):
    """Inclusive scan of the tuple of tensors ``elems`` along ``dim`` under
    the associative ``fn``, combining in ``jax.lax.associative_scan``'s
    order: adjacent pairs, the scan of those recursively (the odd
    results), then each odd result with the next element (the even
    results)."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(t, start, stop=None, step=1):
        return t[(slice(None),) * dim + (slice(start, stop, step),)]

    reduced = fn(tuple(sl(e, 0, n - 1, 2) for e in elems),
                 tuple(sl(e, 1, None, 2) for e in elems))
    odd = _associative_scan(fn, reduced, dim)
    if n % 2 == 0:
        even = fn(tuple(sl(e, 0, e.shape[dim] - 1) for e in odd),
                  tuple(sl(e, 2, None, 2) for e in elems))
    else:
        even = fn(odd, tuple(sl(e, 2, None, 2) for e in elems))
    even = [torch.cat([sl(e, 0, 1), r], dim=dim) for e, r in zip(elems, even)]
    out = []
    for ev, od in zip(even, odd):
        t = ev.new_empty(ev.shape[:dim] + (n,) + ev.shape[dim + 1:])
        t[(slice(None),) * dim + (slice(0, None, 2),)] = ev
        t[(slice(None),) * dim + (slice(1, None, 2),)] = od
        out.append(t)
    return tuple(out)


def chunked_linear_recurrence(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor, *,
                              chunk: int = 256):
    """h_t = a_t * h_{t-1} + b_t along axis 1.

    a, b: (B, S, ...); h0: (B, ...). Returns (all h (B, S, ...), final h).
    The sequence is padded to a whole number of chunks with a = 1, b = 0,
    which carries the state through unchanged."""
    s = a.shape[1]
    c = min(chunk, s)
    pad = (-s) % c
    if pad:
        tail = (0, 0) * (a.ndim - 2) + (0, pad)
        a = F.pad(a, tail, value=1.0)
        b = F.pad(b, tail)
    n_chunks = a.shape[1] // c
    h = h0
    outs = []
    for i in range(n_chunks):
        a_blk = a[:, i * c:(i + 1) * c]
        b_blk = b[:, i * c:(i + 1) * c]
        # Fold the carry into the first element: b'_0 = b_0 + a_0 * h.
        b_blk = torch.cat([(b_blk[:, 0] + a_blk[:, 0] * h)[:, None], b_blk[:, 1:]], dim=1)
        _, cum_b = _associative_scan(_combine, (a_blk, b_blk), 1)
        h = cum_b[:, -1]
        outs.append(cum_b)
    h_all = torch.cat(outs, dim=1) if n_chunks > 1 else outs[0]
    return h_all[:, :s], h


def ssm_scan_chunked_ref(x, dt, b, c, a, d_skip, h0=None, *, chunk: int = 256):
    """The reference's training math for the scan, differentiable: the
    discretized (Bz, S, D, N) tensors ``exp(dt A)`` and ``dt x B`` in
    float32, ``chunked_linear_recurrence`` over them from ``h0`` (zeros
    when None), the states contracted with C, plus ``D x``."""
    x32, dt32 = x.float(), dt.float()
    dta = torch.exp(dt32[..., None] * a.float()[None, None])
    bx = (dt32 * x32)[..., None] * b.float()[:, :, None, :]
    if h0 is None:
        h0 = torch.zeros(dta.shape[:1] + dta.shape[2:], dtype=torch.float32, device=x.device)
    h_all, h_last = chunked_linear_recurrence(dta, bx, h0.float(), chunk=chunk)
    y = torch.einsum("bsdn,bsn->bsd", h_all, c.float())
    return y + x32 * d_skip.float(), h_last


def ssm_scan_bwd_ref(x, dt, b, c, a, d_skip, h0, g_y, g_h):
    """The scan's gradient: ``torch.autograd.grad`` of
    ``ssm_scan_chunked_ref``, recomputed from (x, dt, B, C, A, D_skip,
    h0), with the cotangents ``g_y`` of y and ``g_h`` of h_last. An
    undefined (None) cotangent is skipped: that output is left out, as
    autograd leaves out an output nothing reads. Returns (dx, ddt, dB,
    dC, dA, dD_skip, dh0) in the inputs' dtypes (bf16 x, B and C get
    bf16 gradients), dh0 None where ``h0`` is; an input no defined output
    reaches gets zeros."""
    primals = (x, dt, b, c, a, d_skip) + (() if h0 is None else (h0,))
    picked = [(i, g) for i, g in enumerate((g_y, g_h)) if g is not None]
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in primals]
        grads = (None,) * len(leaves)
        if picked:
            outs = ssm_scan_chunked_ref(*leaves[:6], leaves[6] if h0 is not None else None)
            grads = torch.autograd.grad([outs[i] for i, _ in picked], leaves,
                                        [g for _, g in picked], allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, primals)]
    return (*grads[:6], grads[6] if h0 is not None else None)
