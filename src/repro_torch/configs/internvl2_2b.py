"""InternVL2 2B [arXiv:2404.16821].

VLM: InternViT-300M frontend (STUB — ``input_specs`` provides 256
precomputed patch embeddings at d_model after the MLP projector) +
InternLM2-1.8B LM backbone: 24L, d_model 2048, 16 heads / 8 KV,
d_ff 8192, vocab 92553; rmsnorm + swiglu + rope. Full attention ->
long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92_553,
    head_dim=128,
    norm="rmsnorm",
    mlp_act="silu",
    rope_theta=1e6,
    n_prefix_tokens=256,
)
