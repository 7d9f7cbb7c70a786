"""MiniCPM-2B [arXiv:2404.06395; hf].

Llama-like dense decoder with mu-parameterisation (scaled embeddings,
depth-scaled residuals, scaled logits) and the WSD (warmup-stable-decay)
learning-rate schedule (see repro.train.optimizer.wsd_schedule).
40L, d_model 2304, 36 heads (kv=36 -> MHA), d_ff 5760, vocab 122753.
"""
import math

from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    d_ff=5760,
    vocab_size=122_753,
    head_dim=64,
    tie_embeddings=True,
    scale_emb=12.0,
    scale_residual=1.4 / math.sqrt(40),
    logit_scale=256.0 / 2304.0,
    rope_theta=10_000.0,
    remat_policy="full",
    sub_quadratic=False,
)

# training recipe marker consumed by launch/train.py
LR_SCHEDULE = "wsd"
