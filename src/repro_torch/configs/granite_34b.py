"""Granite Code 34B [arXiv:2405.04324].

Deep-narrow MQA code model: 88L, d_model 6144, 48 heads / 1 KV (MQA),
d_ff 24576, vocab 49152. Llama-style blocks per the assignment note
(rmsnorm + swiglu + rope). The 88-layer depth makes this the best
DHM-pipeline stress case. Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    norm="rmsnorm",
    mlp_act="silu",
    rope_theta=10_000.0,
)
