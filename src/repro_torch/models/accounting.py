"""Parameter / FLOP accounting — the counterpart of
``repro.models.accounting``.

MODEL_FLOPS conventions (as the reference's):
  train    : 6 * N_active * D   (fwd 2ND + bwd 4ND)
  prefill  : 2 * N_active * D
  decode   : 2 * N_active * B   (one token per sequence) + attention reads

``param_count`` builds the real parameter tree on the ``meta`` device
(shapes only, nothing drawn or allocated) where the reference runs
``jax.eval_shape``; it counts every configuration of ``configs/``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig


def param_count(cfg: ArchConfig) -> int:
    """Exact total parameter count (the real initializer on ``meta``)."""
    from repro_torch.models.transformer import _init_params, _leaves

    tree = _init_params(None, cfg, torch.device("meta"))
    return sum(math.prod(t.shape) for t in _leaves(tree))


def _expert_params_per_moe_layer(cfg: ArchConfig) -> int:
    # Per-expert SwiGLU: 3 * d * moe_d_ff.
    return 3 * cfg.d_model * cfg.moe_d_ff


def _n_moe_layers(cfg: ArchConfig) -> int:
    if not cfg.n_experts:
        return 0
    return sum(1 for i in range(cfg.n_layers)
               if cfg.block_pattern[i % len(cfg.block_pattern)] == "attn")


def active_param_count(cfg: ArchConfig) -> int:
    """Parameters touched per token: total minus the (E - top_k) unused
    experts per MoE layer."""
    total = param_count(cfg)
    if not cfg.n_experts:
        return total
    unused = (cfg.n_experts - cfg.top_k) * _expert_params_per_moe_layer(cfg)
    return total - unused * _n_moe_layers(cfg)


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """The 'useful work' FLOP count for one step of the given shape."""
    n_active = active_param_count(cfg)
    if shape.kind == "train":
        d_tokens = shape.seq_len * shape.global_batch
        base = 6.0 * n_active * d_tokens
        attn = 3.0 * _attention_flops(cfg, shape.seq_len, shape.global_batch)
        return base + attn
    if shape.kind == "prefill":
        d_tokens = shape.seq_len * shape.global_batch
        return 2.0 * n_active * d_tokens + _attention_flops(
            cfg, shape.seq_len, shape.global_batch
        )
    # decode: one token per sequence, reading a seq_len-deep cache.
    base = 2.0 * n_active * shape.global_batch
    attn = _decode_attention_flops(cfg, shape.seq_len, shape.global_batch)
    return base + attn


def _visible_kv(cfg: ArchConfig, kind: str, s: int) -> float:
    if kind == "local":
        return min(cfg.window, s)
    if kind == "chunked":
        return min(cfg.chunk, s)
    return s


def _attention_flops(cfg: ArchConfig, s: int, b: int) -> float:
    """Causal/windowed score+value FLOPs across layers (fwd), counted as
    the reference counts them (about half the visible keys per query)."""
    total = 0.0
    hd = cfg.hd
    for i in range(cfg.n_layers):
        if cfg.block_pattern[i % len(cfg.block_pattern)] != "attn":
            continue
        kind_a = cfg.attn_kind_for_layer(i % len(cfg.block_pattern))
        avg = (_visible_kv(cfg, kind_a, s) + 1) / 2
        total += 4.0 * b * s * avg * cfg.n_heads * hd  # QK^T + PV
    return total


def _decode_attention_flops(cfg: ArchConfig, s: int, b: int) -> float:
    total = 0.0
    hd = cfg.hd
    for i in range(cfg.n_layers):
        if cfg.block_pattern[i % len(cfg.block_pattern)] != "attn":
            continue
        kind_a = cfg.attn_kind_for_layer(i % len(cfg.block_pattern))
        total += 4.0 * b * _visible_kv(cfg, kind_a, s) * cfg.n_heads * hd
    return total


def param_bytes(cfg: ArchConfig) -> int:
    bytes_per = getattr(torch, cfg.dtype).itemsize
    return param_count(cfg) * bytes_per
