"""RecurrentGemma 9B (Griffin) [arXiv:2402.19427].

Hybrid: pattern (RG-LRU, RG-LRU, local-attention) repeated — 38 layers =
12 full units + 2 tail RG-LRU blocks. d_model 4096, 16 heads / 1 KV (MQA),
d_ff 12288 GeGLU, lru_width 4096, local window 2048, vocab 256000.
Sub-quadratic (bounded window + O(1) recurrent state) -> long_500k RUNS.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256_000,
    head_dim=256,
    block_pattern=("rglru", "rglru", "attn"),
    attn_pattern=("local", "local", "local"),
    window=2048,
    norm="rmsnorm",
    mlp_act="gelu_glu",
    rope_theta=10_000.0,
    lru_width=4096,
    ssm_conv=4,
)
