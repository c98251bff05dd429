"""Optimization flags for the §Perf hillclimb — the counterpart of
``repro.launch.optflags``, the same fields and names.

Each flag is one hypothesis-driven change; the dry run can trace any cell
with any combination so before/after roofline terms are directly
comparable. ``baseline`` (all off) is the paper-faithful starting point.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class OptFlags:
    # Serving params in TP-only layout (no FSDP all-gathers per layer).
    # Hypothesis: FSDP weight gathers dominate the serving collective term.
    tp_serving_params: bool = False
    # KV cache sharded over the sequence dim ("context parallel" decode).
    # Hypothesis: hd-sharded caches force full-cache reshard copies per
    # layer (measured 550 GB/step on command-r decode); S-sharding makes
    # the token insert slice-local and attention context-parallel.
    seq_sharded_cache: bool = False
    # Keep bf16 operands in attention einsums (accumulate f32 via
    # preferred_element_type) instead of materializing f32 casts.
    no_f32_cast_attn: bool = False
    # Remat the chunked-vocab CE scan step (recompute logits chunks in bwd).
    ce_remat: bool = False
    # Gradient-accumulation microbatches per train step.
    microbatches: int = 1
    # Store SSM discretized inputs in bf16 (states stay f32).
    bf16_ssm: bool = False
    # Pin the batch dim's sharding inside blockwise attention (GSPMD
    # otherwise re-replicates it in the score loop on some cells).
    shard_attn_batch: bool = False
    # MoE capacity factor override (baseline 1.25).
    capacity_factor: float = 0.0  # 0 = keep config value

    @property
    def name(self) -> str:
        parts = []
        if self.tp_serving_params:
            parts.append("tpserve")
        if self.seq_sharded_cache:
            parts.append("seqcache")
        if self.no_f32_cast_attn:
            parts.append("bf16attn")
        if self.ce_remat:
            parts.append("ceremat")
        if self.microbatches > 1:
            parts.append(f"mb{self.microbatches}")
        if self.bf16_ssm:
            parts.append("bf16ssm")
        if self.shard_attn_batch:
            parts.append("attnpin")
        if self.capacity_factor:
            parts.append(f"cf{self.capacity_factor}")
        return "+".join(parts) or "baseline"


BASELINE = OptFlags()

# The full-stack optimized configuration used for the "opt" sweep.
OPTIMIZED = OptFlags(
    tp_serving_params=True,
    seq_sharded_cache=True,
    no_f32_cast_attn=True,
    ce_remat=True,
    microbatches=8,
    bf16_ssm=True,
    shard_attn_batch=True,
)
