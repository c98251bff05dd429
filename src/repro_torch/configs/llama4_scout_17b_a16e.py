"""Llama 4 Scout 17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E].

MoE decoder: 48L, d_model 5120, 40 heads / 8 KV, vocab 202048. Every layer
routes over 16 experts top-1 (+ a shared expert, d_ff 8192 each). iRoPE
attention: 3 of 4 layers use *chunked* attention (8192-token chunks, RoPE);
every 4th layer is full attention with NoPE. The chunked pattern bounds the
KV window -> long_500k RUNS (full-attn layers are O(1)/step at decode with
an O(S) cache).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    head_dim=128,
    block_pattern=("attn", "attn", "attn", "attn"),
    attn_pattern=("chunked", "chunked", "chunked", "causal"),
    chunk=8192,
    norm="rmsnorm",
    mlp_act="silu",
    rope_theta=5e5,
    n_experts=16,
    top_k=1,
    moe_d_ff=8192,
    shared_expert_d_ff=8192,
)
