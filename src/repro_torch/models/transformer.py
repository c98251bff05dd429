"""LM assembly in PyTorch — the counterpart of ``repro.models.transformer``:
heterogeneous block stacks (attention / Mamba / RG-LRU / MoE), the
encoder of encoder-decoder models, prefix embeddings and learned
positions, prefill and single-token decode.

Layer stacking follows the reference so that parameters carry across one
to one: ``block_pattern`` repeats down the stack; with ``scan_layers`` the
parameters of pattern position i are stacked across units into one leaf
with a leading ``n_units`` axis, and ``n_layers mod len(pattern)`` tail
layers are kept apart. ``apply_stack`` loops over the units in Python
where the reference runs ``lax.scan``; a unit's parameters are views
into the stacked leaves.

Decode caches mirror the parameter tree: attention layers hold
ring-buffer KV caches sized to their visibility window (full causal ->
``max_len``; local -> ``window``; chunked -> ``chunk``) and, in
encoder-decoder models, the cross-attention KV computed at prefill; a
Mamba layer holds its (B, d_inner, N) f32 state and its conv window, an
RG-LRU layer its (B, lru_width) f32 state and its conv window.

Prefill writes a prompt's KV tail into the ring at slot ``pos mod S``
for each of its last ``min(s, S)`` positions, so decode reads every
position where ``decode_attention`` expects it. The reference writes the
tail at slots ``0 .. take-1``, which agrees only when ``s <= S`` or S
divides s (``ROADMAP.md``, Queue 3).

``decode_step`` takes the position as a host int or a 0-d integer
tensor on the cache's device, which nothing reads on the host: the ring
slots, the masks and the positions are computed from it on the device,
as the reference computes them from a traced index. A decode step writes
into the cache it runs on (``_decode_into``): each attention layer's new
K/V row at its ring slot, each Mamba and RG-LRU layer's states over its
own, stacked units through their per-unit views. The public
``decode_step`` runs it on a clone of the cache given, which it leaves
as it was; the jitted decode (``launch/steps.py`` ``jit_decode_step``)
runs it on static buffers a CUDA graph replays.

Training: ``train_loss`` and ``chunked_softmax_ce`` (an online
logsumexp over vocab chunks in float32, ``torch.utils.checkpoint`` per
chunk under ``opt_ce_remat``); ``cfg.remat`` checkpoints each pattern
unit when a gradient is being recorded (``"full"`` saves nothing,
``"dots"`` the matmul outputs that carry no batch dimension, as
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``). The last
vocab chunk's padding is masked: the reference slices that chunk with
``dynamic_slice``, which clamps it back inside the vocab, so its loss is
off whenever the chunk does not divide the vocab (``ROADMAP.md``,
Queue 3). A Mamba layer's gradient goes through the scan's backward op
(``kernels/ssm_scan/ops.py``): the reverse-time kernel on the card,
autograd of the reference's composition on the CPU.
``opt_bf16_ssm`` rounds the reference's discretized SSM tensors to bf16;
neither the fused scan nor its backward kernel forms them, so under the
flag the port runs the same f32 scan.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.backends import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.attention import (
    AttnSpec,
    _write_kv_cache,
    blockwise_attention,
    decode_attention,
)
from repro_torch.models.moe import MoESpec, init_moe, moe_apply
from repro_torch.models.ssm import (
    MambaSpec,
    RGLRUSpec,
    init_mamba,
    init_rglru,
    mamba_apply,
    rglru_apply,
)

# ---------------------------------------------------------------------------
# Config-derived specs


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _attn_spec(cfg: ArchConfig, kind: str) -> AttnSpec:
    if kind == "local":
        return AttnSpec("local", window=cfg.window)
    if kind == "chunked":
        return AttnSpec("chunked", chunk=cfg.chunk)
    return AttnSpec(kind)


def _mamba_spec(cfg: ArchConfig) -> MambaSpec:
    return MambaSpec(
        d_model=cfg.d_model,
        d_inner=cfg.ssm_expand * cfg.d_model,
        d_state=cfg.ssm_state,
        d_conv=cfg.ssm_conv,
    )


def _rglru_spec(cfg: ArchConfig) -> RGLRUSpec:
    return RGLRUSpec(d_model=cfg.d_model, lru_width=cfg.lru_width, d_conv=cfg.ssm_conv)


def _moe_spec(cfg: ArchConfig) -> MoESpec:
    return MoESpec(
        d_model=cfg.d_model,
        n_experts=cfg.n_experts,
        top_k=cfg.top_k,
        d_ff=cfg.moe_d_ff,
        capacity_factor=cfg.capacity_factor,
        shared_d_ff=cfg.shared_expert_d_ff,
    )


def _use_rope(cfg: ArchConfig, attn_kind: str) -> bool:
    if cfg.pos_embedding != "rope":
        return False
    # llama4 iRoPE: the periodic full-attention layers carry no positional
    # encoding (NoPE); only chunked layers are rotary.
    if cfg.chunk > 0 and attn_kind == "causal":
        return False
    return True


# ---------------------------------------------------------------------------
# Block init


def _init_attn(generator, cfg: ArchConfig, *, cross: bool = False, device=None) -> dict:
    d, hd = cfg.d_model, cfg.hd
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    dt, device = _dtype(cfg), L._init_device(device)
    kw = dict(bias=cfg.qkv_bias, dtype=dt, device=device)
    p = {
        "wq": L.init_linear(generator, d, nq * hd, **kw),
        "wk": L.init_linear(generator, d, nkv * hd, **kw),
        "wv": L.init_linear(generator, d, nkv * hd, **kw),
        "wo": L.init_linear(generator, nq * hd, d, dtype=dt, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = {"scale": torch.zeros((hd,), dtype=dt, device=device)}
        p["k_norm"] = {"scale": torch.zeros((hd,), dtype=dt, device=device)}
    return p


def _init_ffn(generator, cfg: ArchConfig, *, device=None) -> dict:
    if cfg.n_experts:
        return init_moe(generator, _moe_spec(cfg), dtype=_dtype(cfg), device=device)
    return L.init_mlp(generator, cfg.d_model, cfg.d_ff, act=cfg.mlp_act, dtype=_dtype(cfg),
                      device=device)


def init_block(generator, cfg: ArchConfig, kind: str, *, cross_attn: bool = False,
               device=None) -> dict:
    dt, device = _dtype(cfg), L._init_device(device)
    d = cfg.d_model

    def norm():
        return L.init_norm(d, cfg.norm, dt, device=device)

    if kind == "attn":
        if cfg.parallel_block:
            p = {"ln": norm(), "attn": _init_attn(generator, cfg, device=device),
                 "ffn": _init_ffn(generator, cfg, device=device)}
        else:
            p = {"ln1": norm(), "attn": _init_attn(generator, cfg, device=device),
                 "ln2": norm(), "ffn": _init_ffn(generator, cfg, device=device)}
        if cross_attn:
            p["ln_x"] = norm()
            p["xattn"] = _init_attn(generator, cfg, cross=True, device=device)
        return p
    if kind == "mamba":
        return {"ln1": norm(),
                "mamba": init_mamba(generator, _mamba_spec(cfg), dtype=dt, device=device)}
    if kind == "rglru":
        return {"ln1": norm(),
                "rglru": init_rglru(generator, _rglru_spec(cfg), dtype=dt, device=device),
                "ln2": norm(), "ffn": _init_ffn(generator, cfg, device=device)}
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Block caches (decode)


def init_block_cache(cfg: ArchConfig, kind: str, attn_kind: str, batch: int,
                     max_len: int, *, device=None) -> dict:
    dt, device = _dtype(cfg), L._init_device(device)

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    if kind == "attn":
        if attn_kind == "local":
            s = min(max_len, cfg.window)
        elif attn_kind == "chunked":
            s = min(max_len, cfg.chunk)
        else:
            s = max_len
        cache = {"k": zeros((batch, s, cfg.n_kv_heads, cfg.hd)),
                 "v": zeros((batch, s, cfg.n_kv_heads, cfg.hd))}
        if cfg.n_encoder_layers:  # cross-attention KV (filled at prefill)
            cache["xk"] = zeros((batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.hd))
            cache["xv"] = zeros((batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.hd))
        return cache
    if kind == "mamba":
        spec = _mamba_spec(cfg)
        return {"ssm": zeros((batch, spec.d_inner, spec.d_state), torch.float32),
                "conv": zeros((batch, spec.d_conv - 1, spec.d_inner))}
    if kind == "rglru":
        spec = _rglru_spec(cfg)
        return {"h": zeros((batch, spec.lru_width), torch.float32),
                "conv": zeros((batch, spec.d_conv - 1, spec.lru_width))}
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Block apply


def _split_heads(x, n_heads, hd):
    return x.reshape(x.shape[:-1] + (n_heads, hd))


def _prefill_ring(buf: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """``buf`` (B, S, ...) with the last ``min(s, S)`` of the prompt's ``s``
    rows of ``new`` written at ring slots ``pos mod S``, as a new tensor."""
    s, s_cache = new.shape[1], buf.shape[1]
    if s >= s_cache:
        return torch.roll(new[:, s - s_cache:], shifts=s % s_cache, dims=1).to(buf.dtype)
    out = buf.clone()
    out[:, :s] = new
    return out


def _attn_apply(
    p: dict,
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, S, d)
    attn_kind: str,
    positions,  # (S,) or (B, S)
    *,
    cache=None,
    decode_index=None,
    is_cross: bool = False,
    kv_source=None,  # cross-attention source
    cache_keys=("k", "v"),
):
    b, s, _ = x.shape
    hkv, g, hd = cfg.n_kv_heads, cfg.q_groups, cfg.hd
    spec = _attn_spec(cfg, attn_kind)
    q = _split_heads(L.linear(x, p["wq"]), cfg.n_heads, hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"]["scale"])
    use_rope = _use_rope(cfg, attn_kind) and not is_cross

    if is_cross:
        # Cross attention: KV from encoder states. At prefill they are
        # computed from ``kv_source`` and written into the cache; at decode
        # they are read back (encoder states are static across steps).
        new_cache = cache
        if decode_index is not None:
            k, v = cache[cache_keys[0]], cache[cache_keys[1]]
        else:
            k = _split_heads(L.linear(kv_source, p["wk"]), hkv, hd)
            v = _split_heads(L.linear(kv_source, p["wv"]), hkv, hd)
            if cache is not None:
                new_cache = dict(cache)
                new_cache[cache_keys[0]] = k
                new_cache[cache_keys[1]] = v
        q5 = q.reshape(b, s, hkv, g, hd)
        out = blockwise_attention(q5, k, v, AttnSpec("full"))
    else:
        k = _split_heads(L.linear(x, p["wk"]), hkv, hd)
        v = _split_heads(L.linear(x, p["wv"]), hkv, hd)
        if cfg.qk_norm:
            k = L.rms_norm(k, p["k_norm"]["scale"])
        if use_rope:
            q = L.apply_rope(q, positions, theta=cfg.rope_theta)
            k = L.apply_rope(k, positions, theta=cfg.rope_theta)
        q5 = q.reshape(b, s, hkv, g, hd)
        exact_f32 = not cfg.opt_no_f32_cast_attn
        if decode_index is not None:
            # Single-token decode: the new row written into the ring in place.
            new_cache = _write_kv_cache(cache, k, v, decode_index)
            out = decode_attention(q5, cache["k"], cache["v"], decode_index, spec,
                                   exact_f32=exact_f32)
        else:
            out = blockwise_attention(q5, k, v, spec, exact_f32=exact_f32,
                                      pin_batch=cfg.opt_shard_attn_batch)
            new_cache = cache
            if cache is not None:
                # Prefill: write the (windowed) KV tail into the ring.
                new_cache = dict(cache)
                new_cache["k"] = _prefill_ring(cache["k"], k)
                new_cache["v"] = _prefill_ring(cache["v"], v)
    out = out.reshape(b, s, cfg.n_heads * hd)
    return L.linear(out, p["wo"]), new_cache


def _ffn_apply(p: dict, cfg: ArchConfig, x: torch.Tensor):
    if cfg.n_experts:
        return moe_apply(p, _moe_spec(cfg), x)
    return L.mlp(x, p, act=cfg.mlp_act), torch.zeros((), dtype=torch.float32, device=x.device)


def _store(cache: dict, **new) -> dict:
    """``new``'s states copied over ``cache``'s own (decode). Returns
    ``cache``."""
    for key, t in new.items():
        cache[key].copy_(t)
    return cache


def apply_block(p: dict, cfg: ArchConfig, kind: str, attn_kind: str, x, positions, *,
                cache=None, decode_index=None, encoder_out=None):
    """Returns (x, new_cache, aux_loss). At decode (``decode_index``
    given) the block writes its new state into ``cache`` and returns it."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "attn":
        if cfg.parallel_block:
            h = L.apply_norm(x, p["ln"], cfg.norm)
            a, new_cache = _attn_apply(p["attn"], cfg, h, attn_kind, positions,
                                       cache=cache, decode_index=decode_index)
            f, aux = _ffn_apply(p["ffn"], cfg, h)
            return x + a + f, new_cache, aux
        h = L.apply_norm(x, p["ln1"], cfg.norm)
        a, new_cache = _attn_apply(p["attn"], cfg, h, attn_kind, positions,
                                   cache=cache, decode_index=decode_index)
        x = x + a
        if "xattn" in p:
            hx = L.apply_norm(x, p["ln_x"], cfg.norm)
            ax, new_cache2 = _attn_apply(
                p["xattn"], cfg, hx, "full", positions,
                cache=new_cache, decode_index=decode_index,
                is_cross=True, kv_source=encoder_out, cache_keys=("xk", "xv"),
            )
            new_cache = new_cache2 if new_cache2 is not None else new_cache
            x = x + ax
        h2 = L.apply_norm(x, p["ln2"], cfg.norm)
        f, aux = _ffn_apply(p["ffn"], cfg, h2)
        return x + f, new_cache, aux
    if kind == "mamba":
        h = L.apply_norm(x, p["ln1"], cfg.norm)
        if decode_index is not None or cache is not None:
            y, ssm_new, conv_new = mamba_apply(
                p["mamba"], _mamba_spec(cfg), h,
                ssm_state=cache["ssm"], conv_state=cache["conv"],
            )
            if decode_index is not None:
                new_cache = _store(cache, ssm=ssm_new, conv=conv_new)
            else:
                new_cache = {"ssm": ssm_new, "conv": conv_new}
        else:
            y, _, _ = mamba_apply(p["mamba"], _mamba_spec(cfg), h)
            new_cache = None
        return x + y, new_cache, aux
    if kind == "rglru":
        h = L.apply_norm(x, p["ln1"], cfg.norm)
        if decode_index is not None or cache is not None:
            y, h_new, conv_new = rglru_apply(
                p["rglru"], _rglru_spec(cfg), h,
                h_state=cache["h"], conv_state=cache["conv"],
            )
            if decode_index is not None:
                new_cache = _store(cache, h=h_new, conv=conv_new)
            else:
                new_cache = {"h": h_new, "conv": conv_new}
        else:
            y, _, _ = rglru_apply(p["rglru"], _rglru_spec(cfg), h)
            new_cache = None
        x = x + y
        h2 = L.apply_norm(x, p["ln2"], cfg.norm)
        f, aux = _ffn_apply(p["ffn"], cfg, h2)
        return x + f, new_cache, aux
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Stack = pattern units (leading n_units axis) + tail


def _pattern_layout(cfg: ArchConfig, n_layers: int):
    pat = cfg.block_pattern
    n_units = n_layers // len(pat) if cfg.scan_layers else 0
    tail = n_layers - n_units * len(pat)
    return pat, n_units, tail


def _tree_map(fn, *trees):
    """``fn`` over the leaves of parallel dict/list/None trees."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, list):
        return [_tree_map(fn, *items) for items in zip(*trees)]
    if t0 is None:
        return None
    return fn(*trees)


def _stacked(make_one, n_units: int):
    """Leaves with a leading ``n_units`` axis, filled one unit at a time so
    only one unit's tensors exist beside the stacked ones."""
    first = make_one(0)
    if n_units == 1:
        return _tree_map(lambda t: t.unsqueeze(0), first)
    out = _tree_map(lambda t: t.new_empty((n_units,) + tuple(t.shape)), first)
    for u in range(n_units):
        one = first if u == 0 else make_one(u)
        _tree_map(lambda dst, src: dst[u].copy_(src), out, one)
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def init_stack(generator, cfg: ArchConfig, n_layers: int, *, cross_attn: bool = False,
               device=None) -> dict:
    pat, n_units, tail = _pattern_layout(cfg, n_layers)
    device = L._init_device(device)
    params: dict = {"units": None, "tail": []}
    if n_units:
        params["units"] = [
            _stacked(lambda u, kind=kind: init_block(generator, cfg, kind,
                                                     cross_attn=cross_attn, device=device),
                     n_units)
            for kind in pat
        ]
    for t in range(tail):
        params["tail"].append(init_block(generator, cfg, pat[t % len(pat)],
                                         cross_attn=cross_attn, device=device))
    return params


def init_stack_cache(cfg: ArchConfig, n_layers: int, batch: int, max_len: int, *,
                     device=None) -> dict:
    pat, n_units, tail = _pattern_layout(cfg, n_layers)
    device = L._init_device(device)
    cache: dict = {"units": None, "tail": []}
    if n_units:
        cache["units"] = [
            _tree_map(lambda t: t.new_zeros((n_units,) + tuple(t.shape)),
                      init_block_cache(cfg, kind, cfg.attn_kind_for_layer(i), batch,
                                       max_len, device=device))
            for i, kind in enumerate(pat)
        ]
    for t in range(tail):
        cache["tail"].append(init_block_cache(
            cfg, pat[t % len(pat)], cfg.attn_kind_for_layer(t), batch, max_len,
            device=device))
    return cache


# matmuls with no batch dimension (a linear's (B*S, d) @ (d, n)): what
# jax.checkpoint_policies.dots_with_no_batch_dims_saveable keeps.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(cfg: ArchConfig, fn):
    """``fn`` under ``cfg.remat``: ``"none"`` as is; ``"dots"`` checkpointed
    saving the outputs of matmuls without a batch dimension; anything else
    checkpointed saving nothing (full remat), as the reference's. No RNG
    state is stashed: the LM draws no random numbers, and on the card the
    stash clones the RNG state at every recompute, ops a dry run on
    ``meta`` would not see."""
    if cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(checkpoint, fn, use_reentrant=False, preserve_rng_state=False,
                             **kw)


def apply_stack(params: dict, cfg: ArchConfig, x, positions, *, cache=None,
                decode_index=None, encoder_out=None):
    """Run the full stack. Returns (x, new_cache, total_aux). While a
    gradient is recorded (no cache), each pattern unit runs under
    ``cfg.remat``, as the reference's scanned unit body does. At decode
    every block writes into ``cache`` (a stacked unit through its views
    ``t[u]``) and ``new_cache`` is ``cache`` itself; at prefill it is a
    new tree."""
    pat = cfg.block_pattern
    total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: dict = {"units": None, "tail": []}
    if params["units"] is not None:
        n_units = next(iter(_leaves(params["units"]))).shape[0]
        outs = [[] for _ in pat]

        def unit_body(h, aux, u, unit_cache):
            caches = []
            for i, kind in enumerate(pat):
                p_u = _tree_map(lambda t: t[u], params["units"][i])
                c_u = _tree_map(lambda t: t[u], unit_cache[i]) if unit_cache is not None else None
                h, c_new, a = apply_block(
                    p_u, cfg, kind, cfg.attn_kind_for_layer(i), h, positions,
                    cache=c_u, decode_index=decode_index, encoder_out=encoder_out,
                )
                caches.append(c_new)
                aux = aux + a
            return h, aux, caches

        remat = None
        if cache is None and torch.is_grad_enabled():
            remat = _remat_wrap(cfg, lambda h, aux, u: unit_body(h, aux, u, None)[:2])
        for u in range(n_units):
            if remat is not None:
                x, total_aux = remat(x, total_aux, u)
                continue
            x, total_aux, caches = unit_body(x, total_aux, u,
                                             cache["units"] if cache is not None else None)
            if decode_index is None:  # at decode the blocks wrote into ``cache``
                for i, c_new in enumerate(caches):
                    outs[i].append(c_new)
        if cache is not None and decode_index is None:
            new_cache["units"] = [_tree_map(lambda *ts: torch.stack(ts), *per_pos)
                                  for per_pos in outs]
    for t, p_t in enumerate(params["tail"]):
        kind = pat[t % len(pat)]
        c_t = cache["tail"][t] if cache is not None else None
        x, c_new, a = apply_block(
            p_t, cfg, kind, cfg.attn_kind_for_layer(t), x, positions,
            cache=c_t, decode_index=decode_index, encoder_out=encoder_out,
        )
        new_cache["tail"].append(c_new)
        total_aux = total_aux + a
    if decode_index is not None:
        return x, cache, total_aux
    return x, (new_cache if cache is not None else None), total_aux


# ---------------------------------------------------------------------------
# Full model


def _encoder_cfg(cfg: ArchConfig) -> ArchConfig:
    """The encoder's config: a plain full-attention self-attention stack."""
    return dataclasses.replace(cfg, attn_pattern=("full",), n_encoder_layers=0)


def _init_params(generator, cfg: ArchConfig, device: torch.device) -> dict:
    dt = _dtype(cfg)
    params = {
        "embed": L.embed_init(generator, (cfg.vocab_size, cfg.d_model), dt, device=device),
        "stack": init_stack(generator, cfg, cfg.n_layers,
                            cross_attn=cfg.n_encoder_layers > 0, device=device),
        "final_norm": L.init_norm(cfg.d_model, cfg.norm, dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.xavier_init(
            generator, (cfg.d_model, cfg.vocab_size), dt, device=device)
    if cfg.pos_embedding == "learned":
        params["pos_table"] = L.embed_init(
            generator, (cfg.max_position, cfg.d_model), dt, device=device)
    if cfg.n_encoder_layers:
        params["encoder"] = {
            "pos_table": L.embed_init(generator, (cfg.encoder_seq, cfg.d_model), dt,
                                      device=device),
            "stack": init_stack(generator, _encoder_cfg(cfg), cfg.n_encoder_layers,
                                device=device),
            "norm": L.init_norm(cfg.d_model, cfg.norm, dt, device=device),
        }
    return params


def init_params(generator: torch.Generator, cfg: ArchConfig, *, device=None) -> dict:
    """The reference's parameter tree, drawn from ``generator`` (on its own
    device: a CUDA generator draws on the card) and placed on ``device``
    (the card unless ``device="cpu"``). The numbers differ from the
    reference's ``jax.random`` streams; to run both packages on the same
    weights, carry the reference's tree across with
    ``convert.lm_params_from_numpy``."""
    return _init_params(generator, cfg, resolve_device(device))


def encode(params: dict, cfg: ArchConfig, frames: torch.Tensor) -> torch.Tensor:
    """Audio/vision encoder over precomputed frame embeddings (the modality
    frontend is a stub, as in the reference; frames: (B, encoder_seq, d))."""
    enc = params["encoder"]
    x = frames + enc["pos_table"][None]
    pos = torch.arange(frames.shape[1], device=frames.device)
    x, _, _ = apply_stack(enc["stack"], _encoder_cfg(cfg), x, pos)
    return L.apply_norm(x, enc["norm"], cfg.norm)


def embed_tokens(params, cfg: ArchConfig, tokens, prefix_embeds=None):
    h = params["embed"][tokens]
    if prefix_embeds is not None:
        h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
    return h


def _device_index(index, device) -> torch.Tensor:
    """The decode position as a 0-d long tensor on ``device``: a host int
    filled in there (no host-to-device copy), a tensor left where it is."""
    if isinstance(index, torch.Tensor):
        return index.reshape(()).to(device=device, dtype=torch.long)
    return torch.full((), int(index), dtype=torch.long, device=device)


def forward_hidden(params: dict, cfg: ArchConfig, tokens, *, prefix_embeds=None,
                   encoder_frames=None, cache=None, decode_index=None):
    h = embed_tokens(params, cfg, tokens, prefix_embeds)
    b, s = h.shape[0], h.shape[1]
    if decode_index is not None:
        decode_index = _device_index(decode_index, h.device)
        positions = decode_index.expand(b, 1)
    else:
        positions = torch.arange(s, device=h.device)
    if cfg.pos_embedding == "learned":
        # (B, 1, d) rows at decode, (S, d) broadcast over the batch otherwise.
        h = h + params["pos_table"][positions]
    encoder_out = None
    if encoder_frames is not None:
        encoder_out = encode(params, cfg, encoder_frames)
    h, new_cache, aux = apply_stack(
        params["stack"], cfg, h, positions, cache=cache, decode_index=decode_index,
        encoder_out=encoder_out,
    )
    h = L.apply_norm(h, params["final_norm"], cfg.norm)
    return h, new_cache, aux


def unembed(params: dict, cfg: ArchConfig, h):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(h, w)


# ---------------------------------------------------------------------------
# Chunked-vocab cross-entropy (the (B, S, V) logits never materialize)


def _ce_chunk(h32, w_vocab, targets, m, lse_l, tgt, start: int, c: int):
    """One vocab chunk of the online logsumexp: the logits of columns
    ``start .. start + c - 1`` in float32 (columns past the vocab, the last
    chunk's padding, at -1e30), folded into the running max ``m``, sum
    ``lse_l`` and target logit ``tgt``."""
    w_c = w_vocab[:, start:start + c].float()
    logits = torch.matmul(h32, w_c)
    if w_c.shape[1] < c:
        logits = F.pad(logits, (0, c - w_c.shape[1]), value=-1e30)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    lse_l = lse_l * torch.exp(m - m_new) + torch.exp(logits - m_new[..., None]).sum(dim=-1)
    local = torch.clamp(targets - start, 0, c - 1)
    t_log = torch.gather(logits, -1, local[..., None])[..., 0]
    in_chunk = (targets >= start) & (targets < start + c)
    return m_new, lse_l, torch.where(in_chunk, t_log, tgt)


def chunked_softmax_ce(h, w_vocab, targets, *, vocab_chunk: int = 8192,
                       remat_chunks: bool = False):
    """Mean CE via online logsumexp over vocab chunks, in float32.

    h (B, S, d), ``w_vocab`` (d, V), ``targets`` (B, S) integer.
    ``remat_chunks`` recomputes each logits chunk in the backward pass
    (``torch.utils.checkpoint``) instead of saving it: B*S*V*4 bytes of
    residuals saved for one extra h @ w_c matmul per chunk. The last
    chunk's columns past V are padding, masked at -1e30."""
    b, s, _ = h.shape
    v = w_vocab.shape[1]
    c = min(vocab_chunk, v)
    n_chunks = -(-v // c)
    h32 = h.float()
    targets = targets.long()
    step = _ce_chunk
    if remat_chunks:
        step = functools.partial(checkpoint, _ce_chunk, use_reentrant=False,
                                 preserve_rng_state=False)
    m = torch.full((b, s), -1e30, dtype=torch.float32, device=h.device)
    lse_l = torch.zeros((b, s), dtype=torch.float32, device=h.device)
    tgt = torch.zeros((b, s), dtype=torch.float32, device=h.device)
    for ci in range(n_chunks):
        m, lse_l, tgt = step(h32, w_vocab, targets, m, lse_l, tgt, ci * c, c)
    nll = (m + torch.log(torch.clamp_min(lse_l, 1e-30))) - tgt
    return nll.mean()


def train_loss(params: dict, cfg: ArchConfig, batch: dict, *, aux_weight: float = 0.01,
               vocab_chunk: int = 8192):
    """batch: {'tokens': (B, S+1)} (+ 'prefix_embeds' / 'encoder_frames').
    Returns (loss, {'ce': ce, 'aux': aux}): the next-token CE over the
    token positions (prefix positions sliced off) through the tied or
    untied head, plus ``aux_weight`` times the MoE load-balancing loss."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    h, _, aux = forward_hidden(params, cfg, inputs, prefix_embeds=batch.get("prefix_embeds"),
                               encoder_frames=batch.get("encoder_frames"))
    if batch.get("prefix_embeds") is not None:
        h = h[:, batch["prefix_embeds"].shape[1]:]
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    ce = chunked_softmax_ce(h, w, targets, vocab_chunk=vocab_chunk,
                            remat_chunks=cfg.opt_ce_remat)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Prefill / decode entry points


def prefill(params: dict, cfg: ArchConfig, tokens, *, max_len: int,
            prefix_embeds=None, encoder_frames=None):
    """Process a prompt, returning (last-token logits, primed cache)."""
    b = tokens.shape[0]
    cache = init_stack_cache(cfg, cfg.n_layers, b, max_len, device=tokens.device)
    h, cache, _ = forward_hidden(
        params, cfg, tokens, prefix_embeds=prefix_embeds,
        encoder_frames=encoder_frames, cache=cache,
    )
    logits = unembed(params, cfg, h[:, -1:])[:, 0]
    return logits, cache


def decode_step(params: dict, cfg: ArchConfig, token, cache, index, *, encoder_out=None):
    """One serving step: logits for the next token + updated cache. The
    cache passed in is left as it was: the step writes into a clone of it
    (:func:`_decode_into`). ``index`` is the token's absolute position, a
    host int or a 0-d integer tensor on the cache's device (never read on
    the host). ``encoder_out`` is accepted and ignored, as in the
    reference: the cross-attention KV was written into the cache at
    prefill."""
    return _decode_into(params, cfg, token, _tree_map(torch.clone, cache), index)


def _decode_into(params: dict, cfg: ArchConfig, token, cache, index):
    """One decode step written into ``cache``'s own storage: each
    attention layer's new K/V row at ring slot ``index mod S``, each Mamba
    ``ssm``/``conv`` and RG-LRU ``h``/``conv`` state over the old one,
    stacked units through their per-unit views. Returns (logits,
    ``cache``). The counterpart of the reference's decode step with its
    cache donated; what a decode graph captures."""
    h, cache, _ = forward_hidden(params, cfg, token, cache=cache, decode_index=index)
    logits = unembed(params, cfg, h[:, 0])
    return logits, cache
