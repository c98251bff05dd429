"""Falcon-Mamba 7B [arXiv:2410.05355].

Attention-free Mamba-1 SSM: 64L, d_model 4096, d_inner 8192 (expand 2),
ssm_state 16, conv 4, vocab 65024, rmsnorm. No MLP (d_ff = 0): each layer
is norm -> mamba -> residual. O(1) decode state -> long_500k RUNS.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,  # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab_size=65_024,
    block_pattern=("mamba",),
    norm="rmsnorm",
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    tie_embeddings=False,
)
