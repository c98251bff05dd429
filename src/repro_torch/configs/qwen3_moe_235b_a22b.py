"""Qwen3-235B-A22B MoE [hf:Qwen/Qwen3-235B-A22B].

MoE decoder: 94L, d_model 4096, 64 heads / 4 KV (head_dim 128), vocab
151936. Every layer routes over 128 experts, top-8, per-expert d_ff 1536,
normalized top-k gates, QK-norm (Qwen3 signature). Experts shard over the
``model`` axis (expert parallelism). Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,  # listed dense dim; experts use moe_d_ff below
    vocab_size=151_936,
    head_dim=128,
    qk_norm=True,
    norm="rmsnorm",
    mlp_act="silu",
    rope_theta=1e6,
    n_experts=128,
    top_k=8,
    moe_d_ff=1536,
)
