"""Qwen2-72B [arXiv:2407.10671; hf]: GQA with QKV bias.

80L, d_model 8192, 64 heads, 8 KV heads, d_ff 29568, vocab 152064.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29_568,
    vocab_size=152_064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    remat_policy="full",
    sub_quadratic=False,
)
