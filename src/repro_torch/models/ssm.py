"""State-space / linear-recurrence mixers in PyTorch — the Mamba-1 mixer
(falcon-mamba) and RG-LRU (recurrentgemma / Griffin), the counterpart of
``repro.models.ssm``.

The reference runs the recurrence as a chunked associative scan over the
discretized (B, S, d_inner, N) tensors and contracts the states with C in
an einsum. The port calls the fused selective scan
(``kernels/ssm_scan``) instead: on the card a hand-written kernel that
keeps the states in registers, on the CPU its plain step loop. Both give
the same ``y`` and final state; neither forms the (B, S, d_inner, N)
tensors. In training (grad mode on, an input requiring grad) the scan's
autograd Function keeps that forward; its backward is the scan's
gradient op (``kernels/ssm_scan/ops.py``): on the card a hand-written
reverse-time kernel that recomputes the states chunk by chunk from
checkpoints and forms no (B, S, d_inner, N) tensor either, on the CPU
autograd of the reference's own composition.

RG-LRU runs the reference's ``chunked_linear_recurrence``
(``kernels/ssm_scan/ref.py``; it and its ``_combine`` are imported here
under the reference's names): inside a chunk, ``_associative_scan`` combines elements in the
order ``jax.lax.associative_scan`` does, so the f32 states take the
reference's sums; chunks follow in a Python loop carrying the boundary
state. Decode is the same recurrence on one step.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.kernels.ssm_scan.ref import _combine, chunked_linear_recurrence  # noqa: F401
from repro_torch.models.layers import _gelu, _init_device, _normal, init_linear, linear

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
    ``state_dtype=bfloat16`` mode (``opt_bf16_ssm``) rounds the
    discretized tensors that the fused scan never forms, so under that
    flag the port runs the same f32 scan (``models/transformer.py``)."""
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


# ---------------------------------------------------------------------------
# RG-LRU (Griffin / recurrentgemma recurrent block)


@dataclasses.dataclass(frozen=True)
class RGLRUSpec:
    d_model: int
    lru_width: int
    d_conv: int = 4
    c: float = 8.0  # recurrence sharpness constant


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` written as JAX writes it
    (torch's ``softplus`` returns x itself above 20)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _uniform(generator, shape, low: float, high: float, device) -> torch.Tensor:
    """float32 uniform draws in [low, high) on ``device`` (``meta``: shapes
    only)."""
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    u = torch.rand(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return (low + (high - low) * u).to(device)


def init_rglru(generator, spec: RGLRUSpec, dtype=torch.float32, *, device=None) -> dict:
    """The reference's RG-LRU parameter tree on ``device`` (the card unless
    ``device="cpu"``)."""
    w = spec.lru_width
    device = _init_device(device)
    kw = dict(dtype=dtype, device=device)
    # Lambda init so a^c in [0.9, 0.999] (Griffin appendix).
    u = _uniform(generator, (w,), 0.9, 0.999, device)
    lam = torch.log(torch.expm1(-torch.log(u) / spec.c))  # softplus^-1
    return {
        "in_x": init_linear(generator, spec.d_model, w, **kw),
        "in_gate": init_linear(generator, spec.d_model, w, **kw),
        "conv_w": _normal(generator, (spec.d_conv, w), 0.2, dtype, device),
        "w_r": init_linear(generator, w, w, **kw),
        "w_i": init_linear(generator, w, w, **kw),
        "lam": lam,  # kept f32
        "out": init_linear(generator, w, spec.d_model, **kw),
    }


def rglru_apply(
    p: dict,
    spec: RGLRUSpec,
    x: torch.Tensor,  # (B, S, d_model)
    *,
    h_state: Optional[torch.Tensor] = None,  # (B, lru_width) f32
    conv_state: Optional[torch.Tensor] = None,  # (B, d_conv-1, lru_width)
    chunk: int = 256,
):
    """Griffin recurrent block: gate branch (GeLU) ⊙ (conv → RG-LRU).
    Returns (y, new_h_state, new_conv_state). The gate, the recurrence
    and the output follow the reference op for op: the tanh GeLU, the
    sigmoid gates and ``a``, ``b`` in float32, ``h`` cast back to ``x``'s
    dtype before the gate."""
    gate = _gelu(linear(x, p["in_gate"]))
    u, new_conv = causal_conv1d(linear(x, p["in_x"]), p["conv_w"], state=conv_state)

    r = torch.sigmoid(linear(u, p["w_r"]).float())
    i = torch.sigmoid(linear(u, p["w_i"]).float())
    log_a = -spec.c * _softplus(p["lam"]) * r  # (B, S, W)
    a = torch.exp(log_a)
    gated_x = i * u.float()
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * gated_x
    h0 = (h_state if h_state is not None
          else torch.zeros((x.shape[0], spec.lru_width), dtype=torch.float32, device=x.device))
    h_all, h_last = chunked_linear_recurrence(a, b, h0, chunk=chunk)
    y = h_all.to(x.dtype) * gate
    return linear(y, p["out"]), h_last, new_conv
