"""StableLM 2 12B [hf:stabilityai/stablelm-2-12b].

Dense GQA decoder: 40L, d_model 5120, 32 heads / 8 KV, d_ff 13824,
vocab 100352; rmsnorm + swiglu + rope. Full attention -> long_500k
skipped.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=100_352,
    head_dim=160,
    norm="rmsnorm",
    mlp_act="silu",
    rope_theta=10_000.0,
)
