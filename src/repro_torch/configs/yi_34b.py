"""Yi-34B [arXiv:2403.04652; hf]: llama-arch GQA.

60L, d_model 7168, 56 heads, 8 KV heads, d_ff 20480, vocab 64000.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20_480,
    vocab_size=64_000,
    head_dim=128,
    rope_theta=5_000_000.0,
    remat_policy="full",
    sub_quadratic=False,
)
