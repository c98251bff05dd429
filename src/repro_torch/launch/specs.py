"""Shape stand-ins for every model input, parameter and cache — the
counterpart of ``repro.launch.specs``.

The reference gives ``jax.ShapeDtypeStruct``s with shardings, from
``jax.eval_shape``. The port gives tensors on the ``meta`` device: the
real builders (``transformer.init_params``, ``init_stack_cache``) run
there, so every shape and dtype is the real one and nothing is drawn or
allocated, at any size. The layouts come beside them from
``launch/sharding.py``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch.sharding import cache_specs, named, param_specs
from repro_torch.models.transformer import _init_params, init_stack_cache

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ArchConfig, shape: ShapeConfig, mesh=None) -> dict:
    """Model inputs for one step of the given shape, as meta tensors.

    train/prefill: {'tokens': (B, S[+1])} (+ modality-stub embeddings).
    decode: {'token': (B, 1), 'index': scalar} — the cache is produced by
    ``cache_shapes`` separately. Tokens are int32, as the reference's.
    ``mesh`` is the reference's argument; the inputs' layout is
    ``sharding.batch_specs(input_specs(...), mesh)``, which gives the
    reference's input shardings."""
    b, s = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    out: dict = {}
    if shape.kind == "train":
        out["tokens"] = _meta((b, s + 1), torch.int32)
    elif shape.kind == "prefill":
        out["tokens"] = _meta((b, s), torch.int32)
    else:  # decode / long_decode
        out["token"] = _meta((b, 1), torch.int32)
        out["index"] = _meta((), torch.int32)
    if cfg.family == "vlm" and shape.kind in ("train", "prefill"):
        out["prefix_embeds"] = _meta((b, cfg.n_prefix_tokens, cfg.d_model), dt)
    if cfg.family == "encdec" and shape.kind in ("train", "prefill"):
        out["encoder_frames"] = _meta((b, cfg.encoder_seq, cfg.d_model), dt)
    return out


def params_shapes(cfg: ArchConfig, mesh, *, fsdp: bool = True):
    """(meta param tree, matching ``NamedSharding`` tree, spec tree)."""
    shapes = _init_params(None, cfg, META)
    specs = param_specs(shapes, mesh, fsdp=fsdp)
    return shapes, named(mesh, specs), specs


def cache_shapes(cfg: ArchConfig, shape: ShapeConfig, mesh, *, seq_sharded: bool = False):
    """(meta cache tree, ``NamedSharding`` tree, spec tree) for decode."""
    shapes = init_stack_cache(cfg, cfg.n_layers, shape.global_batch, shape.seq_len,
                              device=META)
    specs = cache_specs(shapes, mesh, cfg, seq_sharded=seq_sharded)
    return shapes, named(mesh, specs), specs
