"""Command R 35B [hf:CohereForAI/c4ai-command-r-v01].

Dense GQA decoder: 40L, d_model 8192, 64 heads / 8 KV, d_ff 22528,
vocab 256000. Cohere blocks are *parallel* (x + attn(ln x) + mlp(ln x)),
use LayerNorm (no bias convention kept via our layernorm), no QKV bias,
tied embeddings. Pure full attention -> long_500k skipped (DESIGN.md
§Arch-applicability).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256_000,
    head_dim=128,
    parallel_block=True,
    norm="layernorm",
    mlp_act="silu",
    rope_theta=8e6,
    tie_embeddings=True,
)
