"""The Mamba-1 mixer (falcon-mamba) in PyTorch — the counterpart of
``repro.models.ssm``.

The reference runs the recurrence as a chunked associative scan over the
discretized (B, S, d_inner, N) tensors and contracts the states with C in
an einsum. The port calls the fused selective scan
(``kernels/ssm_scan``) instead: on the card a hand-written kernel that
keeps the states in registers, on the CPU its plain step loop. Both give
the same ``y`` and final state; neither forms the (B, S, d_inner, N)
tensors.

RG-LRU and ``chunked_linear_recurrence`` are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.models.layers import _normal, _init_device, init_linear, linear

# ---------------------------------------------------------------------------
# Causal depthwise conv1d (the mixer's short 'smear' conv)


def _conv_taps(x: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor]):
    """The causal conv's tap sum in float32, and the new carried window."""
    k = w.shape[0]
    if state is None:
        x_pad = F.pad(x, (0, 0, k - 1, 0))
    else:
        x_pad = torch.cat([state, x], dim=1)
    s = x.shape[1]
    xf, wf = x_pad.float(), w.float()
    y = sum(xf[:, i : i + s] * wf[i][None, None, :] for i in range(k))
    new_state = x_pad[:, x_pad.shape[1] - (k - 1):] if k > 1 else x[:, :0]
    return y, new_state


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, *,
                  state: Optional[torch.Tensor] = None):
    """x: (B, S, D); w: (K, D) depthwise causal. Optional carried state
    (B, K-1, D) for decode. Returns (y, new_state).

    The taps are summed in float32 and rounded to ``x``'s dtype once, as
    the reference's compiled program does with a bf16 chain (XLA keeps
    the intermediates of a fused elementwise chain in f32)."""
    y, new_state = _conv_taps(x, w, state)
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Mamba-1 (selective SSM)


@dataclasses.dataclass(frozen=True)
class MambaSpec:
    d_model: int
    d_inner: int
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)

    @property
    def dtr(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)


def init_mamba(generator, spec: MambaSpec, dtype=torch.float32, *, device=None) -> dict:
    """The reference's Mamba parameter tree on ``device`` (the card unless
    ``device="cpu"``)."""
    di, n, dtr = spec.d_inner, spec.d_state, spec.dtr
    device = _init_device(device)
    kw = dict(dtype=dtype, device=device)
    # S4D-real init for A.
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=device)).repeat(di, 1)
    return {
        "in_proj": init_linear(generator, spec.d_model, 2 * di, **kw),
        "conv_w": _normal(generator, (spec.d_conv, di), 0.2, dtype, device),
        "conv_b": torch.zeros((di,), **kw),
        "x_proj": init_linear(generator, di, dtr + 2 * n, **kw),
        "dt_proj": init_linear(generator, dtr, di, bias=True, **kw),
        "a_log": a_log,  # kept f32 (exp-sensitive)
        "d_skip": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": init_linear(generator, di, spec.d_model, **kw),
    }


def mamba_apply(
    p: dict,
    spec: MambaSpec,
    x: torch.Tensor,  # (B, S, d_model)
    *,
    ssm_state: Optional[torch.Tensor] = None,  # (B, d_inner, N) decode carry
    conv_state: Optional[torch.Tensor] = None,  # (B, d_conv-1, d_inner)
):
    """Returns (y (B, S, d_model), new_ssm_state (B, d_inner, N) f32,
    new_conv_state).

    dtypes follow the reference: ``xin``, B and C stay in the model dtype
    until the scan reads them; dt, the scan, the skip term and the gate
    are float32; the gated output is cast back to ``x.dtype`` before
    ``out_proj``. The conv's taps, its bias and the SiLU run in f32 and
    round to the model dtype once, as the reference's compiled program
    keeps that fused bf16 chain in f32. The reference's
    ``state_dtype=bfloat16`` mode rounds
    the discretized tensors that the fused scan never forms, so it has
    no counterpart here."""
    di, n, dtr = spec.d_inner, spec.d_state, spec.dtr
    xz = linear(x, p["in_proj"])
    xin, z = xz.split(di, dim=-1)  # (B, S, di) each
    taps, new_conv = _conv_taps(xin, p["conv_w"], conv_state)
    xin = F.silu(taps + p["conv_b"].float()).to(x.dtype)

    proj = linear(xin, p["x_proj"])  # (B, S, dtr + 2N)
    dt_in, b_in, c_in = proj.split([dtr, n, n], dim=-1)
    # torch's softplus returns x itself above x = 20 (jax.nn.softplus does
    # not); the two differ there by less than exp(-20).
    dt = F.softplus(linear(dt_in, p["dt_proj"]).float())
    a = -torch.exp(p["a_log"])  # (di, N)
    y, h_last = ssm_scan(xin, dt, b_in, c_in, a, p["d_skip"], ssm_state)
    y = y * F.silu(z.float())
    return linear(y.to(x.dtype), p["out_proj"]), h_last, new_conv
