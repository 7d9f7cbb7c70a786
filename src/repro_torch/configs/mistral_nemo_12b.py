"""Mistral-Nemo-12B [hf:mistralai/Mistral-Nemo-Base-2407].

40L, d_model 5120, 32 heads with explicit head_dim 128, 8 KV heads,
d_ff 14336, vocab 131072, 128k context (rope theta 1M).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,
    vocab_size=131_072,
    head_dim=128,
    rope_theta=1_000_000.0,
    remat_policy="full",
    sub_quadratic=False,
)
