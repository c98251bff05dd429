"""Sharding rules: parameter tree -> partition specs — the counterpart of
``repro.launch.sharding``.

DP/TP/EP layout (megatron-style), as the reference's:
  - batch dims shard over ("pod", "data")
  - attention heads, FFN hidden, expert dim, vocab shard over "model"
  - norms/scales replicate
Rules match on the path of each leaf (e.g. ``stack/units/0/attn/wq/w``) and
right-align to the leaf's rank, so the same rule covers stacked unit and
tail layers.

The port runs on one card and shards nothing yet: these functions give
the layout the reference gives, over the port's dict/list trees (paths
built as the reference's: dict keys, list indices) and any mesh with
``.shape`` (axis -> size) and ``.axis_names``: ``launch/mesh.py``'s
``Mesh``, or a stand-in with the production mesh's sizes. ``P`` is a
tuple of axis entries (an axis name, a tuple of names, or ``None``), as
``jax.sharding.PartitionSpec``; ``named`` pairs each with its mesh.
"""
from __future__ import annotations

import dataclasses
import re

# (path regex, spec for the *trailing* dims). Earlier rules win.
PARAM_RULES = (
    # Attention projections.
    (r"attn/wq/w$", ("data", "model")),
    (r"attn/wk/w$", ("data", "model")),
    (r"attn/wv/w$", ("data", "model")),
    (r"attn/wo/w$", ("model", "data")),
    (r"xattn/w[qkv]/w$", ("data", "model")),
    (r"xattn/wo/w$", ("model", "data")),
    (r"attn/w[qkv]/b$", ("model",)),
    (r"attn/wo/b$", (None,)),
    # Dense MLP.
    (r"ffn/(gate|up)/w$", ("data", "model")),
    (r"ffn/down/w$", ("model", "data")),
    (r"ffn/shared/(gate|up)/w$", ("data", "model")),
    (r"ffn/shared/down/w$", ("model", "data")),
    # MoE experts: expert dim over "model" (expert parallelism).
    (r"ffn/router$", (None, None)),
    (r"ffn/w_(gate|up)$", ("model", "data", None)),
    (r"ffn/w_down$", ("model", None, "data")),
    # Mamba.
    (r"mamba/in_proj/w$", ("data", "model")),
    (r"mamba/conv_w$", (None, "model")),
    (r"mamba/conv_b$", ("model",)),
    (r"mamba/x_proj/w$", ("model", None)),
    (r"mamba/dt_proj/w$", (None, "model")),
    (r"mamba/dt_proj/b$", ("model",)),
    (r"mamba/a_log$", ("model", None)),
    (r"mamba/d_skip$", ("model",)),
    (r"mamba/out_proj/w$", ("model", "data")),
    # RG-LRU.
    (r"rglru/in_(x|gate)/w$", ("data", "model")),
    (r"rglru/conv_w$", (None, "model")),
    (r"rglru/w_[ri]/w$", (None, "model")),
    (r"rglru/lam$", ("model",)),
    (r"rglru/out/w$", ("model", "data")),
    # Embeddings / head / positions.
    (r"(^|/)embed$", ("model", "data")),
    (r"(^|/)lm_head$", ("data", "model")),
    (r"pos_table$", (None, "data")),
    # Everything else (norm scales, biases): replicated.
)


class P(tuple):
    """A partition spec: one entry per leading dim of a leaf (an axis name,
    a tuple of axis names, or ``None`` for replicated); dims past the
    last entry replicate. A one-name tuple is stored as the bare name, as
    ``jax.sharding.PartitionSpec`` stores it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else f"P({self[0]!r})"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the counterpart of ``jax.sharding.NamedSharding``)."""

    mesh: object
    spec: P


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a dict/list tree (``None`` holds no leaf)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    if tree is None:
        return None
    return fn(path, tree)


def _map_specs(fn, tree):
    """``fn`` over the ``P`` leaves of a spec tree."""
    if isinstance(tree, P):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_specs(fn, v) for v in tree]
    return tree


def constrain_spec(spec: P, shape, mesh) -> P:
    """Drop sharding axes that don't evenly divide their dimension (e.g.
    vocab 92553 over a 16-wide axis, or batch 1 at long_500k decode)."""
    out = []
    for i, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        total = 1
        for a in axes:
            total *= mesh.shape[a]
        if i < len(shape) and shape[i] % total == 0:
            out.append(entry)
        else:
            # Try a prefix of the axis tuple before giving up entirely.
            kept = []
            run = 1
            for a in axes:
                if i < len(shape) and shape[i] % (run * mesh.shape[a]) == 0:
                    kept.append(a)
                    run *= mesh.shape[a]
            out.append(tuple(kept) if len(kept) > 1 else (kept[0] if kept else None))
    return P(*out)


def _spec_for(path_s: str, ndim: int, mesh_axes) -> P:
    for pat, trailing in PARAM_RULES:
        if re.search(pat, path_s):
            spec = [None] * ndim
            t = list(trailing)[-ndim:] if ndim < len(trailing) else list(trailing)
            spec[ndim - len(t):] = t
            # Drop axes the mesh doesn't have; 'data' on params is only used
            # for FSDP mode (see fsdp arg below) and dropped otherwise.
            spec = [a if a in mesh_axes else None for a in spec]
            return P(*spec)
    return P()


def param_specs(params, mesh, *, fsdp: bool = False):
    """Spec tree for a parameter (or optimizer-state) tree.

    With ``fsdp=False`` (default) the 'data' entries in the rules are
    dropped: parameters replicate over the data axis (pure DP + TP). With
    ``fsdp=True`` they are honored, fully sharding every matrix over
    (data x model) — ZeRO-3-style, the default for the big train shapes.
    """
    keep = set(mesh.axis_names) - (set() if fsdp else {"data", "pod"})

    def f(path, leaf):
        spec = _spec_for(_path_str(path), leaf.ndim, keep)
        return constrain_spec(spec, tuple(leaf.shape), mesh)

    return _map_with_path(f, params)


def named(mesh, spec_tree):
    return _map_specs(lambda s: NamedSharding(mesh, s), spec_tree)


def _daxes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_specs(batch, mesh):
    """Shard every batch array's leading dim over (pod, data)."""
    daxes = _daxes(mesh)

    def f(_, leaf):
        if not leaf.ndim:
            return P()
        return constrain_spec(P(daxes, *([None] * (leaf.ndim - 1))), tuple(leaf.shape), mesh)

    return _map_with_path(f, batch)


def cache_specs(cache, mesh, cfg, *, seq_sharded: bool = False):
    """KV/state cache sharding for decode.

    Batch over (pod, data). Baseline: KV heads shard over 'model' when
    divisible, else the head_dim axis takes the model axis. With
    ``seq_sharded`` (context-parallel decode) the cache's *sequence* dim
    takes the model axis instead. SSM/RG-LRU states shard their feature
    dim over 'model'.
    """
    daxes = _daxes(mesh)
    model_size = mesh.shape.get("model", 1)

    def f(path, leaf):
        path_s = _path_str(path)
        ndim, shape = leaf.ndim, tuple(leaf.shape)
        # Stacked leading (n_units) dim present for unit caches.
        lead = [None] * (ndim - 4) if ndim >= 4 else [None] * max(0, ndim - 3)
        if re.search(r"(^|/)(k|v|xk|xv)$", path_s) and ndim >= 4:
            n_kv = shape[-2]
            if seq_sharded:
                spec = P(*lead, daxes, "model", None, None)
            elif n_kv % model_size == 0:
                spec = P(*lead, daxes, None, "model", None)
            else:
                spec = P(*lead, daxes, None, None, "model")
        elif re.search(r"/ssm$", path_s):  # (..., B, d_inner, N)
            spec = P(*([None] * (ndim - 3)), daxes, "model", None)
        elif re.search(r"/conv$", path_s):  # (..., B, K-1, d_inner)
            spec = P(*([None] * (ndim - 3)), daxes, None, "model")
        elif re.search(r"/h$", path_s):  # (..., B, lru_width)
            spec = P(*([None] * (ndim - 2)), daxes, "model")
        elif ndim:
            spec = P(*([None] * ndim))
        else:
            return P()
        return constrain_spec(spec, shape, mesh)

    return _map_with_path(f, cache)
