"""Configuration schema for the model zoo and workload shapes.

Every assigned architecture is a ``ModelConfig``; every workload cell is
a ``ShapeConfig``.  ``reduced()`` produces the CPU-smoke-test variant of
a config (same family/topology, tiny dims).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    num_experts_per_tok: int
    d_ff_expert: int
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # group-local dispatch: argsort/scatter stay within token groups
    # (aligned to data shards); 1 = flat global dispatch
    dispatch_groups: int = 1
    # expert-TP: shard the expert FFN hidden dim over "model" instead of
    # the experts dim — dispatch/combine stay shard-local and only
    # [tokens, d] partial sums cross the mesh (vs k*capacity-amplified
    # buffers under expert parallelism)
    expert_tp: bool = False
    # layers that stay dense (e.g. deepseek-v2 first layer), by index
    dense_layers: Tuple[int, ...] = ()
    d_ff_dense: int = 0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2)."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD block parameters."""

    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8  # every k-th block is sLSTM, rest mLSTM
    proj_factor: float = 2.0
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style: shared attention block woven between SSM layers."""

    shared_attn_every: int = 6
    lora_rank: int = 64


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | encdec | ssm | hybrid | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # MiniCPM-style mu-parameterisation
    scale_emb: float = 1.0
    scale_residual: float = 1.0
    logit_scale: float = 1.0
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    hybrid: Optional[HybridConfig] = None
    # encoder-decoder
    enc_layers: int = 0
    dec_layers: int = 0
    # modality frontend stub: precomputed embeddings prepended to tokens
    frontend: Optional[str] = None  # "audio" | "vision"
    frontend_len: int = 0  # patches/frames per example (train shapes)
    # execution
    scan_layers: bool = True
    remat_policy: str = "none"  # none | full | dots
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # capability flags
    sub_quadratic: bool = False  # can run long_500k
    has_decode: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding/head tables are padded to a multiple of 256 so the
        vocab dim shards cleanly over the model axis; the loss masks the
        padded logit columns (exact — see chunked_softmax_xent)."""
        return (self.vocab_size + 255) // 256 * 256

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks)."""
        d, l = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "moe", "vlm"):
            attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
            if self.mla:
                m = self.mla
                attn = (
                    d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
                    + d * self.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                    + self.num_heads * m.v_head_dim * d
                )
            if self.moe:
                moe_l = l - len(self.moe.dense_layers)
                total_e = self.moe.num_experts + self.moe.num_shared_experts
                ffn = moe_l * 3 * d * self.moe.d_ff_expert * total_e + moe_l * d * self.moe.num_experts
                ffn += len(self.moe.dense_layers) * 3 * d * (self.moe.d_ff_dense or self.d_ff)
            else:
                ffn = l * 3 * d * self.d_ff
            return emb + l * attn + ffn
        if self.family == "encdec":
            attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
            enc = self.enc_layers * (attn + 3 * d * self.d_ff)
            dec = self.dec_layers * (2 * attn + 3 * d * self.d_ff)
            return emb + enc + dec
        if self.family == "ssm":
            # xLSTM: projections dominate
            return emb + l * int(6 * d * d)
        if self.family == "hybrid":
            ssm = l * int(5.5 * d * d)
            shared = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d + 3 * d * self.d_ff
            return emb + ssm + shared
        raise ValueError(self.family)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE top-k instead of all experts)."""
        if not self.moe:
            return self.param_count()
        d, l = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
        if self.mla:
            m = self.mla
            attn = (
                d * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
                + d * self.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                + self.num_heads * m.v_head_dim * d
            )
        moe_l = l - len(self.moe.dense_layers)
        act_e = self.moe.num_experts_per_tok + self.moe.num_shared_experts
        ffn = moe_l * 3 * d * self.moe.d_ff_expert * act_e
        ffn += len(self.moe.dense_layers) * 3 * d * (self.moe.d_ff_dense or self.d_ff)
        return emb + l * attn + ffn


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k needs sub-quadratic attention; decode needs a decoder."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False
    if shape.kind == "decode" and not cfg.has_decode:
        return False
    return True


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests."""
    kw = dict(
        num_layers=min(cfg.num_layers, 4),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        frontend_len=8 if cfg.frontend else 0,
        enc_layers=min(cfg.enc_layers, 2),
        dec_layers=min(cfg.dec_layers, 2),
        remat_policy="none",
    )
    if cfg.moe:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=4,
            num_experts_per_tok=min(cfg.moe.num_experts_per_tok, 2),
            d_ff_expert=64,
            d_ff_dense=128 if cfg.moe.dense_layers else 0,
            capacity_factor=8.0,  # dropless at smoke scale: decode == forward
        )
    if cfg.mla:
        kw["mla"] = MLAConfig(
            kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16
        )
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16, chunk=16)
    if cfg.xlstm:
        kw["xlstm"] = dataclasses.replace(cfg.xlstm, slstm_every=2)
    if cfg.hybrid:
        kw["hybrid"] = dataclasses.replace(cfg.hybrid, shared_attn_every=2, lora_rank=8)
    return dataclasses.replace(cfg, **kw)
