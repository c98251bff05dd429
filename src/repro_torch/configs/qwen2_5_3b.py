"""Qwen2.5 3B [hf:Qwen/Qwen2.5-3B].

Dense GQA decoder: 36L, d_model 2048, 16 heads / 2 KV, d_ff 11008,
vocab 151936. Qwen2 family uses QKV *bias* (assignment note), rmsnorm,
swiglu, rope theta 1e6, tied embeddings at this size. Full attention ->
long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab_size=151_936,
    head_dim=128,
    qkv_bias=True,
    norm="rmsnorm",
    mlp_act="silu",
    rope_theta=1e6,
    tie_embeddings=True,
)
