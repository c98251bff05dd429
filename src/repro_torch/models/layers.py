"""Core NN layers in PyTorch (functional, dict params): norms, linear
(dense, pow2 QAT, packed pow2), rotary embeddings and gated MLPs — the
counterpart of ``repro.models.layers``.

Layouts stay the reference's: linear weights ``(d_in, d_out)``, norms as
``{"scale"[, "bias"]}``. Initializers draw from a ``torch.Generator`` on
the generator's own device (a CUDA generator draws on the card, so a
7B-parameter tree never passes through host memory) and land on
``device``: the card unless the caller passes ``device="cpu"``, as every
entry point of the port (``kernels/backends.py``). Their numbers differ
from the reference's ``jax.random`` streams, so the tests carry the
reference's params across with ``convert.lm_params_from_numpy``. A
``meta`` device draws nothing: it builds the tree's shapes only
(``accounting.param_count``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.quant.packing import pack_codes_u4, unpack_codes_u4
from repro_torch.core.quant.pow2 import decode_pow2, pow2_codes, project_pow2_ste
from repro_torch.kernels.backends import resolve_device

# ---------------------------------------------------------------------------
# Initialization


def _init_device(device=None) -> torch.device:
    """A builder's device: ``resolve_device`` (the card unless
    ``device="cpu"``), or ``meta`` for shapes only."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def _normal(generator: torch.Generator, shape, std: float, dtype, device) -> torch.Tensor:
    device = _init_device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32)
    return w.mul_(std).to(device=device, dtype=dtype)


def he_init(generator, shape, dtype, fan_in=None, *, device=None):
    fan_in = fan_in or shape[0]
    return _normal(generator, shape, math.sqrt(2.0 / fan_in), dtype, device)


def xavier_init(generator, shape, dtype, *, device=None):
    fan_in, fan_out = shape[0], shape[-1]
    return _normal(generator, shape, math.sqrt(2.0 / (fan_in + fan_out)), dtype, device)


def embed_init(generator, shape, dtype, *, device=None):
    return _normal(generator, shape, 0.02, dtype, device)


# ---------------------------------------------------------------------------
# Norms


def rms_norm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """The reference's RMSNorm: in float32, scaled by ``1 + weight``
    (weights start at zero), cast back to ``x``'s dtype. Not
    ``torch.nn.RMSNorm``, which scales by ``weight``."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(dtype)


def layer_norm(x: torch.Tensor, weight, bias, *, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(dtype)


def apply_norm(x, p: dict, kind: str):
    if kind == "rmsnorm":
        return rms_norm(x, p["scale"])
    if kind == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    raise ValueError(kind)


def init_norm(d: int, kind: str, dtype=torch.float32, *, device=None) -> dict:
    device = _init_device(device)
    if kind == "rmsnorm":
        return {"scale": torch.zeros((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Linear — three weight modes, as in the reference:
#   dense        : w (d_in, d_out)
#   pow2_qat     : dense weights, pow2-projected with STE on the fly
#   pow2_packed  : 4-bit codes (two per byte) + per-channel scale, decoded
#                  in the graph


def linear(x: torch.Tensor, p: dict, *, quant=None) -> torch.Tensor:
    if "codes" in p:  # pow2_packed
        codes = unpack_codes_u4(p["codes"])
        # Odd widths are packed with a zero pad column; the scale keeps the
        # true width.
        n = p["scale"].shape[-1]
        w = decode_pow2(codes[..., :n], p["scale"]).to(x.dtype)
    elif quant == "pow2_qat":
        w = project_pow2_ste(p["w"])
    else:
        w = p["w"]
    if x.dtype != w.dtype:
        # Mixed operands promote, as the reference's einsum promotes them
        # (float32 frames into a bf16 encoder compute in float32).
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    out = torch.matmul(x, w)
    if "b" in p:
        out = out + p["b"]
    return out


def init_linear(generator, d_in: int, d_out: int, *, bias: bool = False,
                dtype=torch.float32, device=None) -> dict:
    device = _init_device(device)
    p = {"w": xavier_init(generator, (d_in, d_out), dtype, device=device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def pack_linear_pow2(p: dict) -> dict:
    """Convert a dense linear param dict to packed pow2 serving format.

    Odd output widths are packed with a zero pad column (zero codes decode
    to 0.0); the stored scale keeps the true width so ``linear`` can slice
    the decoded weights back.

    Stacked (scan-layer) weights of shape ``(*lead, K, N)`` are packed
    per layer, so every layer keeps its own per-channel scales; the
    stored scale then has shape ``(*lead, 1, N)`` so a per-layer slice
    broadcasts as ``(1, N)``.
    """
    w = p["w"]
    n = w.shape[-1]
    if n % 2:
        w = F.pad(w, (0, 1))
    if w.ndim == 2:
        codes, scale = pow2_codes(w, channel_axis=1)
        out = {"codes": pack_codes_u4(codes), "scale": scale.reshape(-1)[:n]}
    else:
        lead = tuple(w.shape[:-2])
        per_layer = [pow2_codes(wi, channel_axis=1)
                     for wi in w.reshape((-1,) + tuple(w.shape[-2:]))]
        codes = torch.stack([c for c, _ in per_layer])
        scale = torch.stack([sc for _, sc in per_layer])  # (L, 1, N')
        out = {
            "codes": pack_codes_u4(codes).reshape(lead + (w.shape[-2], w.shape[-1] // 2)),
            "scale": scale[..., :n].reshape(lead + (1, n)),
        }
    if "b" in p:
        out["b"] = p["b"]
    return out


def pack_params_pow2(params):
    """Walk a param tree and pack every linear (any dict with a >= 2D
    ``w``) to the pow2 serving format — the whole-stack constant
    specialization the paper's tactic becomes at serving time."""
    if isinstance(params, dict):
        if "w" in params and getattr(params["w"], "ndim", 0) >= 2:
            return pack_linear_pow2(params)
        return {k: pack_params_pow2(v) for k, v in params.items()}
    if isinstance(params, list):
        return [pack_params_pow2(v) for v in params]
    return params


# ---------------------------------------------------------------------------
# Rotary position embeddings


def rope_frequencies(head_dim: int, theta: float = 10_000.0, *, device=None):
    device = _init_device(device)
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float = 10_000.0):
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, device=x.device)
    angles = positions[..., None].float() * freqs  # (..., S, Dh/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, Dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLPs


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation.
    return F.gelu(x, approximate="tanh")


def mlp(x, p: dict, *, act: str = "silu", quant=None):
    """SwiGLU/GeGLU/plain-GELU feed-forward."""
    if act in ("silu", "gelu_glu"):
        gate = linear(x, p["gate"], quant=quant)
        up = linear(x, p["up"], quant=quant)
        g = F.silu(gate) if act == "silu" else _gelu(gate)
        return linear(g * up, p["down"], quant=quant)
    if act == "gelu":  # plain 2-layer (whisper)
        h = _gelu(linear(x, p["up"], quant=quant))
        return linear(h, p["down"], quant=quant)
    raise ValueError(act)


def init_mlp(generator, d: int, d_ff: int, *, act: str = "silu", bias: bool = False,
             dtype=torch.float32, device=None) -> dict:
    kw = dict(bias=bias, dtype=dtype, device=_init_device(device))
    if act in ("silu", "gelu_glu"):
        return {
            "gate": init_linear(generator, d, d_ff, **kw),
            "up": init_linear(generator, d, d_ff, **kw),
            "down": init_linear(generator, d_ff, d, **kw),
        }
    if act == "gelu":
        return {
            "up": init_linear(generator, d, d_ff, **kw),
            "down": init_linear(generator, d_ff, d, **kw),
        }
    raise ValueError(act)
