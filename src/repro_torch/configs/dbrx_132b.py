"""DBRX-132B [hf:databricks/dbrx-base; unverified]: fine-grained MoE.

40L, d_model 6144, 48 heads (GQA kv=8), 16 experts top-4 with expert
d_ff 10752, vocab 100352.
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10_752,
    vocab_size=100_352,
    head_dim=128,
    rope_theta=500_000.0,
    moe=MoEConfig(
        num_experts=16,
        num_experts_per_tok=4,
        d_ff_expert=10_752,
        capacity_factor=1.25,
        # optimized layout (EXPERIMENTS.md §Perf): group-local dispatch +
        # expert-TP — 5x less collective time than flat expert-parallel
        dispatch_groups=16,
        expert_tp=True,
    ),
    remat_policy="full",
    sub_quadratic=False,
)
