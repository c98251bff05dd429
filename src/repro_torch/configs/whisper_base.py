"""Whisper base [arXiv:2212.04356].

Encoder-decoder: 6+6L, d_model 512, 8 heads (MHA: kv=8), d_ff 2048,
vocab 51865. LayerNorm + plain-GELU MLP + *learned* positional embeddings
(no rope). The conv audio frontend is a STUB: ``input_specs`` provides
precomputed frame embeddings (B, 1500, 512) per the assignment. Decode
shapes run with the assigned 32k self-attention cache (a stress config;
the real model caps at 448 decoder positions — noted in DESIGN.md).
Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51_865,
    head_dim=64,
    norm="layernorm",
    mlp_act="gelu",
    pos_embedding="learned",
    max_position=32_768 + 8,  # assigned decode_32k stress shape
    n_encoder_layers=6,
    encoder_seq=1500,
)
