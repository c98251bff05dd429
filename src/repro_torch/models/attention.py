"""Attention in PyTorch — the counterpart of ``repro.models.attention``:
GQA/MQA/MHA with blockwise (flash-style) online-softmax computation,
causal / sliding-window / chunked masks, and KV-cache decode.

The blockwise loop is the reference's, in eager PyTorch ops: a Python
loop over q blocks and, inside it, over kv blocks with a running max,
sum and output, so the S x S score matrix never materialises. No library
attention is called (the numbers are the reference's: the finite
``NEG_INF`` mask, f32 scores, the same rescaling order).

Scores are float32 in both precision modes. ``exact_f32=True`` casts
both operands to f32; ``exact_f32=False`` is the reference's bf16
operands with f32 accumulation, which here is the same upcast (a bf16
product is exact in f32) followed by the reference's one rounding of the
probabilities to the value dtype before the PV product. A bf16
``torch.matmul`` would round the scores themselves.

The reference's ``_constrain`` is the identity without an ambient mesh;
the port has no ambient mesh, so ``pin_batch`` keeps only its repeat and
reshape of K/V, the same arithmetic.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _init_device

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """Static attention configuration for one layer."""

    kind: str = "causal"  # causal | local | chunked | full
    window: int = 0  # local: kv in (q - window, q]
    chunk: int = 0  # chunked: causal within q//chunk == kv//chunk


def _mask(spec: AttnSpec, q_pos: torch.Tensor, kv_pos: torch.Tensor) -> torch.Tensor:
    """(Sq, Skv) boolean mask: True = attend."""
    dq, dk = q_pos[:, None], kv_pos[None, :]
    if spec.kind == "full":
        return torch.ones((q_pos.numel(), kv_pos.numel()), dtype=torch.bool,
                          device=q_pos.device)
    m = dk <= dq  # causal
    if spec.kind == "local":
        m = m & (dk > dq - spec.window)
    elif spec.kind == "chunked":
        m = m & (torch.div(dk, spec.chunk, rounding_mode="floor")
                 == torch.div(dq, spec.chunk, rounding_mode="floor"))
    elif spec.kind != "causal":
        raise ValueError(spec.kind)
    return m


def _scale(dh: int) -> float:
    """``1 / sqrt(dh)`` rounded as the reference rounds it (sqrt and
    reciprocal in float32)."""
    return float(torch.tensor(float(dh), dtype=torch.float32).sqrt().reciprocal())


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, Sq, Hkv, G, Dh) x (B, Skv, Hkv, Dh) -> f32 (B, Hkv, G, Sq, Skv):
    one batched product per (B, Hkv), the G query heads of a KV head
    stacked on its rows."""
    b, sq, hkv, g, dh = q.shape
    qf = q.float().permute(0, 2, 3, 1, 4).reshape(b, hkv, g * sq, dh)
    kf = k.float().permute(0, 2, 3, 1)  # (B, Hkv, Dh, Skv)
    return (torch.matmul(qf, kf) * scale).view(b, hkv, g, sq, k.shape[1])


def _pv(p: torch.Tensor, v: torch.Tensor, exact_f32: bool) -> torch.Tensor:
    """(B, Hkv, G, Sq, Skv) x (B, Skv, Hkv, Dh) -> f32 (B, Hkv, G, Sq, Dh).
    Without ``exact_f32`` the probabilities round to the value dtype first,
    as the reference's bf16-operand einsum does."""
    if not exact_f32:
        p = p.to(v.dtype)
    b, hkv, g, sq, skv = p.shape
    vf = v.float().permute(0, 2, 1, 3)  # (B, Hkv, Skv, Dh)
    out = torch.matmul(p.float().reshape(b, hkv, g * sq, skv), vf)
    return out.view(b, hkv, g, sq, v.shape[-1])


def blockwise_attention(
    q: torch.Tensor,  # (B, Sq, Hkv, G, Dh)
    k: torch.Tensor,  # (B, Skv, Hkv, Dh)
    v: torch.Tensor,  # (B, Skv, Hkv, Dh)
    spec: AttnSpec,
    *,
    q_offset: int = 0,
    q_block: int = 1024,
    kv_block: int = 1024,
    exact_f32: bool = True,
    pin_batch: bool = False,
) -> torch.Tensor:
    """Online-softmax attention; returns (B, Sq, Hkv, G, Dh) in q's dtype
    (with ``pin_batch``, (B, Sq, Hkv*G, 1, Dh), as the reference)."""
    if pin_batch:
        b0, s0, hkv0, g0, dh0 = q.shape
        if g0 > 1:
            k = torch.repeat_interleave(k, g0, dim=2)
            v = torch.repeat_interleave(v, g0, dim=2)
            q = q.reshape(b0, s0, hkv0 * g0, 1, dh0)
    b, sq, hkv, g, dh = q.shape
    skv = k.shape[1]
    scale = _scale(dh)
    qb = min(q_block, sq)
    kb = min(kv_block, skv)
    # Pad to block multiples.
    sq_p, skv_p = -(-sq // qb) * qb, -(-skv // kb) * kb
    q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, sq_p - sq))
    k = F.pad(k, (0, 0, 0, 0, 0, skv_p - skv))
    v = F.pad(v, (0, 0, 0, 0, 0, skv_p - skv))
    n_q, n_kv = sq_p // qb, skv_p // kb
    dev = q.device
    outs = []
    for qi in range(n_q):
        q_blk = q[:, qi * qb:(qi + 1) * qb]
        q_pos = q_offset + qi * qb + torch.arange(qb, device=dev)
        m_run = torch.full((b, hkv, g, qb), NEG_INF, dtype=torch.float32, device=dev)
        l_run = torch.zeros((b, hkv, g, qb), dtype=torch.float32, device=dev)
        o_run = torch.zeros((b, hkv, g, qb, dh), dtype=torch.float32, device=dev)
        for kj in range(n_kv):
            k_blk = k[:, kj * kb:(kj + 1) * kb]
            v_blk = v[:, kj * kb:(kj + 1) * kb]
            kv_pos = kj * kb + torch.arange(kb, device=dev)
            s = _scores(q_blk, k_blk, scale)  # (B, Hkv, G, qb, kb)
            mask = _mask(spec, q_pos, kv_pos) & (kv_pos < skv)[None, :]
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m_run - m_new)
            l_run = l_run * alpha + p.sum(dim=-1)
            o_run = o_run * alpha[..., None] + _pv(p, v_blk, exact_f32)
            m_run = m_new
        o = o_run / torch.clamp_min(l_run[..., None], 1e-30)
        outs.append(o.permute(0, 3, 1, 2, 4))  # (B, qb, Hkv, G, Dh)
    out = torch.cat(outs, dim=1) if n_q > 1 else outs[0]
    return out[:, :sq].to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # (B, 1, Hkv, G, Dh)
    cache_k: torch.Tensor,  # (B, S_cache, Hkv, Dh)
    cache_v: torch.Tensor,
    cur_index,  # position of the new token: a host int or a 0-d integer tensor
    spec: AttnSpec,
    *,
    exact_f32: bool = True,
) -> torch.Tensor:
    """Single-token attention against a KV cache (the serve_step path).

    The cache is a ring buffer: slot i holds absolute position
    ``cur - ((cur - i) mod S)``; for an unwrapped cache (S > cur) this
    reduces to position i. Windowed/chunked layers size their cache to the
    window so old positions are naturally evicted. A tensor ``cur_index``
    (on the cache's device) is never read on the host: the mask is
    computed on the device, as the reference computes it from a traced
    index.
    """
    cur = cur_index
    s_cache = cache_k.shape[1]
    scale = _scale(q.shape[-1])
    slots = torch.arange(s_cache, device=q.device)
    kv_pos = cur - torch.remainder(cur - slots, s_cache)
    ok = (kv_pos >= 0) & (kv_pos <= cur)
    if spec.kind == "local":
        ok = ok & (kv_pos > cur - spec.window)
    elif spec.kind == "chunked":
        ok = ok & (torch.div(kv_pos, spec.chunk, rounding_mode="floor") == cur // spec.chunk)
    s = _scores(q, cache_k, scale)  # (B, Hkv, G, 1, S_cache)
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = _pv(p, cache_v, exact_f32)  # (B, Hkv, G, 1, Dh)
    return o.permute(0, 3, 1, 2, 4).to(q.dtype)


def init_kv_cache(batch: int, max_len: int, n_kv: int, head_dim: int, dtype, *,
                  device=None) -> dict:
    """Zero K and V caches on ``device`` (the card unless ``device="cpu"``)."""
    device = _init_device(device)
    shape = (batch, max_len, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _ring_slot(index, s_cache: int, device) -> torch.Tensor:
    """The ring slot ``index mod S`` as a (1,) long tensor on ``device``
    (the reference's ``jnp.mod``): a host int is filled in there, a
    tensor index stays on the device."""
    if isinstance(index, torch.Tensor):
        return torch.remainder(index.reshape(1).to(torch.long), s_cache)
    return torch.full((1,), int(index) % s_cache, dtype=torch.long, device=device)


def update_kv_cache(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor, index) -> dict:
    """Insert (B, 1, Hkv, Dh) new KV at position ``index`` (mod cache len —
    ring-buffer semantics for windowed layers; a host int or a 0-d
    integer tensor on the cache's device). Returns a new cache; the one
    given is left as it was."""
    return _write_kv_cache({"k": cache["k"].clone(), "v": cache["v"].clone()},
                           k_new, v_new, index)


def _write_kv_cache(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor, index) -> dict:
    """:func:`update_kv_cache` written into ``cache``'s own K and V (views
    of a stacked cache write through to it). Returns ``cache``."""
    slot = _ring_slot(index, cache["k"].shape[1], cache["k"].device)
    cache["k"].index_copy_(1, slot, k_new.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot, v_new.to(cache["v"].dtype))
    return cache
