"""Mixture-of-Experts FFN in PyTorch — the counterpart of
``repro.models.moe``: token-choice top-k routing with per-group capacity
(GShard/Switch semantics), gather-based dispatch.

Dispatch builds an (E, C) token-index table per routing group with a
cumsum and a scatter, then gathers, as the reference does. Groups are
the batch rows; where the reference ``vmap``s ``_route_group`` over
them, the port routes all groups in one batched pass (``_route_group``
takes a leading group axis).

Capacity: a (token, slot) past its expert's capacity is dropped, and
only kept slots are scattered into the table, so an overflowing expert
keeps its first ``C`` tokens. The reference also scatters dropped slots,
to slot 0 of their expert, where on XLA:CPU the last write wins and the
token kept there loses its output (``ROADMAP.md``, Queue 3); the two
agree wherever no expert overflows.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _init_device, mlp, xavier_init


@dataclasses.dataclass(frozen=True)
class MoESpec:
    d_model: int
    n_experts: int
    top_k: int
    d_ff: int  # per-expert hidden dim
    capacity_factor: float = 1.25
    shared_d_ff: int = 0  # optional always-on shared expert (llama4)
    norm_topk: bool = True  # renormalize top-k gate weights (qwen3)

    def capacity(self, tokens_per_group: int) -> int:
        c = int(tokens_per_group * self.top_k * self.capacity_factor
                / self.n_experts)
        return max(self.top_k, min(c, tokens_per_group))


def init_moe(generator, spec: MoESpec, dtype=torch.float32, *, device=None) -> dict:
    """The reference's MoE parameter tree on ``device`` (the card unless
    ``device="cpu"``); the router stays float32."""
    e, d, f = spec.n_experts, spec.d_model, spec.d_ff
    device = _init_device(device)
    p = {
        "router": xavier_init(generator, (d, e), torch.float32, device=device),
        "w_gate": xavier_init(generator, (e, d, f), dtype, device=device),
        "w_up": xavier_init(generator, (e, d, f), dtype, device=device),
        "w_down": xavier_init(generator, (e, f, d), dtype, device=device),
    }
    if spec.shared_d_ff:
        sf = spec.shared_d_ff
        p["shared"] = {
            "gate": {"w": xavier_init(generator, (d, sf), dtype, device=device)},
            "up": {"w": xavier_init(generator, (d, sf), dtype, device=device)},
            "down": {"w": xavier_init(generator, (sf, d), dtype, device=device)},
        }
    return p


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort keeps equal values in index
    order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(ids: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``F.one_hot(ids, n)`` in ``dtype``, as one comparison with
    ``arange``: the same ops on every device (``F.one_hot`` checks the
    ids' range on the CPU, scatters on the card and compares on ``meta``),
    so a dry run's op log is the card's."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).to(dtype)


def _expert_positions(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """The position of each (token, slot) within its expert, in token
    order: ``flat_e`` (G, T*k) holds the experts of the flattened (T*k)
    slots, token-major; the cumsum runs over that order."""
    onehot = _one_hot(flat_e, n_experts, torch.int64)  # (G, T*k, E)
    return (torch.cumsum(onehot, dim=1) - 1).gather(2, flat_e[..., None])[..., 0]


def _route_group(x: torch.Tensor, p: dict, spec: MoESpec):
    """Route each group. x: (G, T, d), one routing group a row. Returns
    (y (G, T, d), aux_loss (G,))."""
    grp, t, d = x.shape
    e, k = spec.n_experts, spec.top_k
    c = spec.capacity(t)
    dev = x.device

    logits = torch.matmul(x.float(), p["router"].float())  # (G, T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = _top_k(probs, k)  # (G, T, k)
    if spec.norm_topk:
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    flat_e = expert_ids.reshape(grp, t * k)
    pos_in_e = _expert_positions(flat_e, e)
    keep = pos_in_e < c

    # (E, C) token-index table; -1 = empty slot. Dropped slots write to a
    # spare column past the table, which is cut off.
    spare = e * c
    dest = torch.where(keep, flat_e * c + pos_in_e, spare)
    token_idx = torch.arange(t, device=dev).repeat_interleave(k).expand(grp, t * k)
    table = torch.full((grp, spare + 1), -1, dtype=torch.long, device=dev)
    table.scatter_(1, dest, torch.where(keep, token_idx, -1))
    table = table[:, :spare]
    slot_ok = table >= 0  # (G, E*C)
    slot_gate = torch.zeros((grp, spare + 1), dtype=torch.float32, device=dev)
    slot_gate.scatter_(1, dest, torch.where(keep, gate_vals.reshape(grp, t * k), 0.0))
    slot_gate = slot_gate[:, :spare]

    src = table.clamp_min(0)
    gathered = torch.gather(x, 1, src[..., None].expand(grp, spare, d))
    gathered = torch.where(slot_ok[..., None], gathered, 0.0).view(grp, e, c, d)

    # Expert FFN (SwiGLU), batched over experts.
    h_g = torch.einsum("gecd,edf->gecf", gathered, p["w_gate"])
    h_u = torch.einsum("gecd,edf->gecf", gathered, p["w_up"])
    h = F.silu(h_g) * h_u
    y_e = torch.einsum("gecf,efd->gecd", h, p["w_down"])  # (G, E, C, d)

    # Combine: each slot's output back to its token, weighted by its gate
    # value, summed in float32.
    y_flat = y_e.reshape(grp, spare, d).float() * slot_gate[..., None]
    y_flat = torch.where(slot_ok[..., None], y_flat, 0.0)
    out = torch.zeros((grp, t, d), dtype=torch.float32, device=dev)
    out.scatter_add_(1, src[..., None].expand(grp, spare, d), y_flat)

    # Switch load-balancing aux loss: E * sum_e f_e * P_e.
    f_e = _one_hot(expert_ids, e, torch.float32).sum(dim=2).mean(dim=1)  # (G, E)
    p_e = probs.mean(dim=1)
    aux = e * ((f_e / k) * p_e).sum(dim=-1)
    return out.to(x.dtype), aux


def moe_apply(p: dict, spec: MoESpec, x: torch.Tensor):
    """x: (B, S, d) -> (y (B, S, d), aux_loss scalar). Routing groups are
    the batch rows."""
    y, aux = _route_group(x, p, spec)
    if spec.shared_d_ff:
        y = y + mlp(x, p["shared"], act="silu")
    return y, aux.mean()
