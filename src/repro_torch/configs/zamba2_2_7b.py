"""Zamba2-2.7B [arXiv:2411.15242; hf]: Mamba2 trunk + shared attention.

54 Mamba2 layers (d_model 2560, ssm_state 64) with ONE shared
attention+MLP block (32 heads, d_ff 10240) applied every 6 layers with
per-invocation LoRA.  Sub-quadratic: runs long_500k.
"""
from .base import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10_240,
    vocab_size=32_000,
    head_dim=80,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=128),
    hybrid=HybridConfig(shared_attn_every=6, lora_rank=64),
    remat_policy="full",
    sub_quadratic=True,
)
