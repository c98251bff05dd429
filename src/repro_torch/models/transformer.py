"""LM assembly in PyTorch — the counterpart of ``repro.models.transformer``,
for stacks of Mamba blocks (falcon-mamba): init, prefill and single-token
decode.

Layer stacking follows the reference so that parameters carry across one
to one: ``block_pattern`` repeats down the stack; with ``scan_layers`` the
parameters of pattern position i are stacked across units into one leaf
with a leading ``n_units`` axis, and ``n_layers mod len(pattern)`` tail
layers are kept apart. ``apply_stack`` loops over the units in Python
where the reference runs ``lax.scan``; a unit's parameters are views
into the stacked leaves. Decode caches mirror the parameter tree: a Mamba
layer holds its (B, d_inner, N) f32 state and its (B, d_conv-1, d_inner)
conv window.

Not ported yet, and raising ``ValueError``: attention and RG-LRU
blocks, MoE, the encoder (enc-dec), prefix embeddings (VLM), learned
positions and the reference's ``opt_bf16_ssm`` mode. The training loss
is not ported either.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.backends import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.ssm import MambaSpec, init_mamba, mamba_apply

# ---------------------------------------------------------------------------
# Config-derived specs


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _mamba_spec(cfg: ArchConfig) -> MambaSpec:
    return MambaSpec(
        d_model=cfg.d_model,
        d_inner=cfg.ssm_expand * cfg.d_model,
        d_state=cfg.ssm_state,
        d_conv=cfg.ssm_conv,
    )


_BF16_SSM = (
    "opt_bf16_ssm=True rounds the discretized SSM tensors to bf16, which "
    "the fused scan never forms: the port runs the f32 recurrence only"
)


def _not_ported(what: str) -> ValueError:
    return ValueError(f"{what} is not yet ported to repro_torch (only Mamba stacks are)")


def _check_ported(cfg: ArchConfig) -> None:
    for kind in cfg.block_pattern:
        if kind != "mamba":
            raise _not_ported(f"block kind {kind!r}")
    if cfg.n_experts:
        raise _not_ported("MoE")
    if cfg.n_encoder_layers:
        raise _not_ported("the encoder")
    if cfg.pos_embedding == "learned":
        raise _not_ported("the learned position table")
    if cfg.opt_bf16_ssm:
        raise ValueError(_BF16_SSM)


# ---------------------------------------------------------------------------
# Blocks


def init_block(generator, cfg: ArchConfig, kind: str, *, device=None) -> dict:
    if kind != "mamba":
        raise _not_ported(f"block kind {kind!r}")
    dt, device = _dtype(cfg), L._init_device(device)
    return {
        "ln1": L.init_norm(cfg.d_model, cfg.norm, dt, device=device),
        "mamba": init_mamba(generator, _mamba_spec(cfg), dtype=dt, device=device),
    }


def init_block_cache(cfg: ArchConfig, kind: str, attn_kind: str, batch: int,
                     max_len: int, *, device=None) -> dict:
    if kind != "mamba":
        raise _not_ported(f"block kind {kind!r}")
    spec, device = _mamba_spec(cfg), L._init_device(device)
    return {
        "ssm": torch.zeros((batch, spec.d_inner, spec.d_state), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, spec.d_conv - 1, spec.d_inner), dtype=_dtype(cfg),
                            device=device),
    }


def apply_block(p: dict, cfg: ArchConfig, kind: str, attn_kind: str, x, positions, *,
                cache=None, decode_index=None, encoder_out=None):
    """Returns (x, new_cache, aux_loss)."""
    if kind != "mamba":
        raise _not_ported(f"block kind {kind!r}")
    if cfg.opt_bf16_ssm:
        raise ValueError(_BF16_SSM)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.apply_norm(x, p["ln1"], cfg.norm)
    if decode_index is not None or cache is not None:
        y, ssm_new, conv_new = mamba_apply(
            p["mamba"], _mamba_spec(cfg), h,
            ssm_state=cache["ssm"], conv_state=cache["conv"],
        )
        new_cache = {"ssm": ssm_new, "conv": conv_new}
    else:
        y, _, _ = mamba_apply(p["mamba"], _mamba_spec(cfg), h)
        new_cache = None
    return x + y, new_cache, aux


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


def init_stack(generator, cfg: ArchConfig, n_layers: int, *, device=None) -> dict:
    pat, n_units, tail = _pattern_layout(cfg, n_layers)
    device = L._init_device(device)
    params: dict = {"units": None, "tail": []}
    if n_units:
        params["units"] = [
            _stacked(lambda u, kind=kind: init_block(generator, cfg, kind, device=device),
                     n_units)
            for kind in pat
        ]
    for t in range(tail):
        params["tail"].append(init_block(generator, cfg, pat[t % len(pat)], device=device))
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


def apply_stack(params: dict, cfg: ArchConfig, x, positions, *, cache=None,
                decode_index=None, encoder_out=None):
    """Run the full stack. Returns (x, new_cache, total_aux)."""
    pat = cfg.block_pattern
    total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: dict = {"units": None, "tail": []}
    if params["units"] is not None:
        n_units = next(iter(_leaves(params["units"]))).shape[0]
        outs = [[] for _ in pat]
        for u in range(n_units):
            for i, kind in enumerate(pat):
                p_u = _tree_map(lambda t: t[u], params["units"][i])
                c_u = (_tree_map(lambda t: t[u], cache["units"][i])
                       if cache is not None else None)
                x, c_new, a = apply_block(
                    p_u, cfg, kind, cfg.attn_kind_for_layer(i), x, positions,
                    cache=c_u, decode_index=decode_index, encoder_out=encoder_out,
                )
                outs[i].append(c_new)
                total_aux = total_aux + a
        if cache is not None:
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
    return x, (new_cache if cache is not None else None), total_aux


# ---------------------------------------------------------------------------
# Full model


def _init_params(generator, cfg: ArchConfig, device: torch.device) -> dict:
    _check_ported(cfg)
    dt = _dtype(cfg)
    params = {
        "embed": L.embed_init(generator, (cfg.vocab_size, cfg.d_model), dt, device=device),
        "stack": init_stack(generator, cfg, cfg.n_layers, device=device),
        "final_norm": L.init_norm(cfg.d_model, cfg.norm, dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.xavier_init(
            generator, (cfg.d_model, cfg.vocab_size), dt, device=device)
    return params


def init_params(generator: torch.Generator, cfg: ArchConfig, *, device=None) -> dict:
    """The reference's parameter tree, drawn from ``generator`` (on its own
    device: a CUDA generator draws on the card) and placed on ``device``
    (the card unless ``device="cpu"``). The numbers differ from the
    reference's ``jax.random`` streams; to run both packages on the same
    weights, carry the reference's tree across with
    ``convert.lm_params_from_numpy``."""
    return _init_params(generator, cfg, resolve_device(device))


def embed_tokens(params, cfg: ArchConfig, tokens, prefix_embeds=None):
    if prefix_embeds is not None:
        raise _not_ported("prefix embeddings (VLM)")
    return params["embed"][tokens]


def forward_hidden(params: dict, cfg: ArchConfig, tokens, *, prefix_embeds=None,
                   encoder_frames=None, cache=None, decode_index=None):
    if encoder_frames is not None:
        raise _not_ported("the encoder")
    h = embed_tokens(params, cfg, tokens, prefix_embeds)
    b, s = h.shape[0], h.shape[1]
    if decode_index is not None:
        positions = torch.as_tensor(decode_index, device=h.device).expand(b, 1)
    else:
        positions = torch.arange(s, device=h.device)
    h, new_cache, aux = apply_stack(
        params["stack"], cfg, h, positions, cache=cache, decode_index=decode_index,
    )
    h = L.apply_norm(h, params["final_norm"], cfg.norm)
    return h, new_cache, aux


def unembed(params: dict, cfg: ArchConfig, h):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(h, w)


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
    cache passed in is left as it was."""
    if encoder_out is not None:
        raise _not_ported("the encoder")
    h, new_cache, _ = forward_hidden(params, cfg, token, cache=cache, decode_index=index)
    logits = unembed(params, cfg, h[:, 0])
    return logits, new_cache
