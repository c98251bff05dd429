"""Plain PyTorch version of the fused selective-SSM scan.

Semantics (Mamba-1 inner recurrence, diagonal A), as the reference's
``repro/kernels/ssm_scan/ref.py``:

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) outer B_t
    y_t = (h_t . C_t) + D * x_t

Shapes: x, dt (Bz, S, D); B, C (Bz, S, N); A (D, N); D_skip (D,);
h0 (Bz, D, N) or None (zeros). Everything is computed in float32.
Returns (y (Bz, S, D) f32, h_last (Bz, D, N) f32).

A step loop: it holds one (Bz, D, N) state, never the (Bz, S, D, N)
discretized tensors.
"""
from __future__ import annotations

import torch


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
