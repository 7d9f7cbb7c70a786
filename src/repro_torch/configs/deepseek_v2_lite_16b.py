"""DeepSeek-V2-Lite-16B [arXiv:2405.04434; hf].

27L, d_model 2048, 16 heads with MLA (kv_lora 512, rope head 64),
MoE: 64 routed experts top-6 + 2 shared, expert d_ff 1408; the first
layer keeps a dense FFN (d_ff 10944).  Vocab 102400.
"""
from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102_400,
    rope_theta=10_000.0,
    mla=MLAConfig(
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=64,
        num_experts_per_tok=6,
        d_ff_expert=1408,
        num_shared_experts=2,
        dense_layers=(0,),
        d_ff_dense=10_944,
        # optimized layout (EXPERIMENTS.md §Perf, dbrx cell): group-local
        # dispatch + expert-TP
        dispatch_groups=16,
        expert_tp=True,
    ),
    remat_policy="full",
    sub_quadratic=False,
)
