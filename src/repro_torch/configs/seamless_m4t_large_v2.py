"""SeamlessM4T-Large-v2 backbone [arXiv:2308.11596; hf].

Encoder-decoder transformer backbone ONLY; the speech frontend is a
stub (``input_specs`` supplies precomputed frame embeddings).  24 enc +
24 dec layers, d_model 1024, 16 heads, d_ff 8192, vocab 256206.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,
    enc_layers=24,
    dec_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256_206,
    head_dim=64,
    frontend="audio",
    frontend_len=4096,
    remat_policy="full",
    sub_quadratic=False,
)
