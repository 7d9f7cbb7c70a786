"""InternVL2-26B backbone [arXiv:2404.16821; hf].

InternLM2-20B language backbone (48L, d_model 6144, 48 heads GQA kv=8,
d_ff 16384, vocab 92553).  The InternViT vision tower is a STUB:
``input_specs`` provides precomputed patch embeddings that are
prepended to the token embeddings.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16_384,
    vocab_size=92_553,
    head_dim=128,
    rope_theta=1_000_000.0,
    frontend="vision",
    frontend_len=1024,
    remat_policy="full",
    sub_quadratic=False,
)
