"""Config schema shared by all architectures, plus the assigned input-shape
set and the config registry."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # Block structure ------------------------------------------------------
    block_pattern: Tuple[str, ...] = ("attn",)  # cycle: attn | mamba | rglru
    attn_pattern: Tuple[str, ...] = ("causal",)  # cycle over *attn* layers
    window: int = 0  # local-attention window
    chunk: int = 0  # chunked-attention chunk (llama4 iRoPE)
    parallel_block: bool = False  # x + attn(ln x) + mlp(ln x) (command-r)
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    mlp_act: str = "silu"  # silu | gelu_glu | gelu
    qkv_bias: bool = False
    qk_norm: bool = False  # qwen3
    rope_theta: float = 10_000.0
    pos_embedding: str = "rope"  # rope | learned | none
    max_position: int = 0  # learned pos table size
    tie_embeddings: bool = False
    # MoE --------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    shared_expert_d_ff: int = 0
    capacity_factor: float = 1.25
    # SSM / RG-LRU -------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    lru_width: int = 0
    # Encoder-decoder ----------------------------------------------------
    n_encoder_layers: int = 0
    encoder_seq: int = 0  # whisper: 1500 frames after the conv stub
    # VLM ----------------------------------------------------------------
    n_prefix_tokens: int = 0  # precomputed patch embeddings prepended
    # Misc -----------------------------------------------------------------
    dtype: str = "bfloat16"
    remat: str = "full"  # full | dots | none
    scan_layers: bool = True
    # §Perf optimization switches (see launch/optflags.py; default = the
    # paper-faithful baseline).
    opt_no_f32_cast_attn: bool = False  # bf16 attn operands, f32 accumulate
    opt_ce_remat: bool = False  # recompute CE logit chunks in backward
    opt_bf16_ssm: bool = False  # bf16 SSM discretized inputs
    opt_shard_attn_batch: bool = False  # pin batch sharding inside attention

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_groups(self) -> int:
        return self.n_heads // self.n_kv_heads if self.n_kv_heads else 0

    @property
    def is_subquadratic(self) -> bool:
        """True when no layer attends over unbounded context (long_500k ok)."""
        if all(b != "attn" for b in self.block_pattern):
            return True
        return all(k in ("local", "chunked") for k in self.attn_pattern) or (
            self.window > 0 and "causal" not in self.attn_pattern
        )

    def supports_shape(self, shape: "ShapeConfig") -> bool:
        if shape.kind == "long_decode":
            # Sub-quadratic only (see DESIGN.md §Arch-applicability). Archs
            # with a bounded-window pattern qualify even if a minority of
            # layers are full-attention ONLY when those layers are
            # attention-free... llama4's 1:4 full-attn layers use a decode
            # KV cache that stays O(S) in memory but O(1) per step compute;
            # we admit patterns whose quadratic-layer fraction is 0, plus
            # ssm/hybrid/chunked families.
            return self.family in ("ssm", "hybrid") or self.chunk > 0
        return True

    def attn_kind_for_layer(self, layer_idx: int) -> str:
        return self.attn_pattern[layer_idx % len(self.attn_pattern)]

    def scaled_down(self, **overrides) -> "ArchConfig":
        """A reduced same-family config for CPU smoke tests."""
        small = dict(
            n_layers=max(2, len(self.block_pattern)),
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, 4 // max(1, self.q_groups)),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            window=min(self.window, 16) if self.window else 0,
            chunk=min(self.chunk, 16) if self.chunk else 0,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            moe_d_ff=64 if self.moe_d_ff else 0,
            shared_expert_d_ff=64 if self.shared_expert_d_ff else 0,
            ssm_state=min(self.ssm_state, 8),
            lru_width=64 if self.lru_width else 0,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 16) if self.encoder_seq else 0,
            n_prefix_tokens=min(self.n_prefix_tokens, 8),
            max_position=min(self.max_position, 128) if self.max_position else 0,
            dtype="float32",
            remat="none",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode | long_decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "long_decode"),
}

ARCH_IDS = (
    "command-r-35b",
    "granite-34b",
    "stablelm-12b",
    "qwen2.5-3b",
    "whisper-base",
    "internvl2-2b",
    "recurrentgemma-9b",
    "qwen3-moe-235b-a22b",
    "llama4-scout-17b-a16e",
    "falcon-mamba-7b",
)


def get_arch(name: str) -> ArchConfig:
    mod = importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_")
    )
    return mod.CONFIG


def list_archs():
    return list(ARCH_IDS)
