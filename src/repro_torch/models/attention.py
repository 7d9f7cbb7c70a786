"""Attention blocks: GQA with optional QKV bias, and MLA (DeepSeek-V2
latent attention with a compressed KV cache).

The counterpart of the GQA and MLA parts of ``repro.models.attention``,
for the decoders' causal self-attention with RoPE.  A KV cache is a
preallocated fixed-length buffer; ``gqa_attention`` and
``mla_attention`` write the new tokens into the buffers they are given,
in place, and return them (the reference returns new arrays;
``lm._trunk`` copies the caches once per step, so a caller's cache is
left as it was).  Cross-attention and the options the reference's
encoder-decoder and vlm models set (``kv_x``, ``causal``, ``use_rope``,
``kv_valid``) wait for those models (ROADMAP item 12).

The reference's ``constrain`` calls are dropped: without sharding rules
they do nothing, and one device has none.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from .common import ParamInfo, ShapeDtype, apply_rope

_NEG = -1e30  # the reference's fill for masked scores


# ----------------------------------------------------------------------
# GQA
# ----------------------------------------------------------------------
def gqa_params(cfg: ModelConfig) -> Dict[str, ParamInfo]:
    d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    p = {
        "wq": ParamInfo((d, h * hd), ("embed", "heads")),
        "wk": ParamInfo((d, kv * hd), ("embed", "heads")),
        "wv": ParamInfo((d, kv * hd), ("embed", "heads")),
        "wo": ParamInfo((h * hd, d), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = ParamInfo((h * hd,), ("heads",), init="zeros")
        p["bk"] = ParamInfo((kv * hd,), ("heads",), init="zeros")
        p["bv"] = ParamInfo((kv * hd,), ("heads",), init="zeros")
    return p


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, t, _ = x.shape
    return x.reshape(b, t, n, -1)


def _sdpa_naive(
    q: torch.Tensor,  # [B, Tq, H, hd]
    k: torch.Tensor,  # [B, Tk, KV, hd]
    v: torch.Tensor,  # [B, Tk, KV, hd_v]
    mask: Optional[torch.Tensor],  # [B|1, Tq, Tk] bool
    scale: float,
) -> torch.Tensor:
    """Reference attention; materialises [B, H, Tq, Tk] (tests only)."""
    b, tq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, tq, kvh, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * scale
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores, _NEG)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(b, tq, h * v.shape[-1])


def _divisor_chunk(n: int, target: int) -> int:
    c = min(target, n)
    while n % c:
        c -= 1
    return c


def _dot_f32(eq: str, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``einsum`` with float32 accumulation (the reference's
    ``preferred_element_type=float32``): a product of two bf16 values is
    exact in float32, so upcasting first sums the same products."""
    return torch.einsum(eq, x.float(), y.float())


def _sdpa_chunked(
    q: torch.Tensor,  # [B, Tq, H, hd]
    k: torch.Tensor,  # [B, S, KV, hd]
    v: torch.Tensor,  # [B, S, KV, hd_v]
    scale: float,
    q_positions: torch.Tensor,  # [Tq] absolute: query i sees keys <= q_positions[i]
    q_chunk: int = 512,
    k_chunk: int = 1024,
) -> torch.Tensor:
    """Causal online-softmax attention over [qc, kc] blocks, the
    reference's: -1e30 for masked scores, a float32 running max, sum and
    accumulator, ``acc / max(l, 1e-30)`` at the end.  The reference's two
    ``scan``s are loops over the same chunks; its ``kv_limit`` and
    ``kv_valid`` masks, which the decoders never set, wait for the models
    that do (ROADMAP item 12)."""
    b, tq, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    hv = v.shape[-1]
    qc = _divisor_chunk(tq, q_chunk)
    kc = _divisor_chunk(s, k_chunk)
    nq, nk = tq // qc, s // kc
    dev = q.device

    qg = q.reshape(b, nq, qc, kvh, g, hd)
    kg = k.reshape(b, nk, kc, kvh, hd)
    vg = v.reshape(b, nk, kc, kvh, hv)
    qpos = q_positions.reshape(nq, qc)

    outs = []
    for iq in range(nq):
        qb = qg[:, iq]  # [b, qc, kv, g, hd]
        m = torch.full((b, kvh, g, qc), _NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((b, kvh, g, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kvh, g, qc, hv), dtype=torch.float32, device=dev)
        for ik in range(nk):
            kb = kg[:, ik]  # [b, kc, kv, hd]
            vb = vg[:, ik]
            sc = _dot_f32("bqkgd,bskd->bkgqs", qb, kb) * scale  # [b, kv, g, qc, kc]
            kpos = ik * kc + torch.arange(kc, device=dev)
            sc = torch.where(kpos[None, :] <= qpos[iq][:, None], sc, _NEG)
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + _dot_f32("bkgqs,bskd->bkgqd", p.to(vb.dtype), vb)
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]  # [b, kv, g, qc, hv]
        outs.append(out.permute(0, 3, 1, 2, 4))  # [b, qc, kv, g, hv]
    out = torch.stack(outs, dim=1).reshape(b, tq, h * hv)
    return out.to(q.dtype)


def gqa_attention(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # [B, T, d]
    positions: torch.Tensor,  # [B, T]
    cfg: ModelConfig,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    impl: str = "chunked",
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    h, kv = cfg.num_heads, cfg.num_kv_heads
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = apply_rope(_split_heads(q, h), positions, cfg.rope_theta)
    k = apply_rope(_split_heads(k, kv), positions, cfg.rope_theta)
    v = _split_heads(v, kv)
    scale = 1.0 / math.sqrt(q.shape[-1])

    if cache is None:
        if impl == "naive":
            tq, tk = q.shape[1], k.shape[1]
            ar_k = torch.arange(tk, device=x.device)
            ar_q = torch.arange(tq, device=x.device)
            out = _sdpa_naive(q, k, v, (ar_k[None, :] <= ar_q[:, None])[None], scale)
        else:
            out = _sdpa_chunked(q, k, v, scale, q_positions=positions[0])
        return out @ p["wo"].to(dt), None

    # decode/prefill-with-cache: write T tokens at cache["idx"], attend
    # causally over the valid prefix (works for T == 1 and T == seq).
    idx = cache["idx"]
    tq = q.shape[1]
    slots = idx.long() + torch.arange(tq, device=x.device)
    ck = cache["k"].index_copy_(1, slots, k.to(cache["k"].dtype))
    cv = cache["v"].index_copy_(1, slots, v.to(cache["v"].dtype))
    out = _sdpa_chunked(q, ck.to(dt), cv.to(dt), scale, q_positions=slots)
    return out @ p["wo"].to(dt), {"k": ck, "v": cv, "idx": idx.add_(tq)}


def gqa_cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "k": ShapeDtype((batch, max_len, kv, hd), torch.bfloat16),
        "v": ShapeDtype((batch, max_len, kv, hd), torch.bfloat16),
        "idx": ShapeDtype((), torch.int32),
    }


# ----------------------------------------------------------------------
# MLA (DeepSeek-V2): low-rank compressed KV with a decoupled RoPE head
# ----------------------------------------------------------------------
def mla_params(cfg: ModelConfig) -> Dict[str, ParamInfo]:
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq": ParamInfo((d, h * qd), ("embed", "heads")),
        "w_dkv": ParamInfo((d, m.kv_lora_rank + m.qk_rope_head_dim), ("embed", None)),
        "w_uk": ParamInfo((m.kv_lora_rank, h * m.qk_nope_head_dim), (None, "heads")),
        "w_uv": ParamInfo((m.kv_lora_rank, h * m.v_head_dim), (None, "heads")),
        "wo": ParamInfo((h * m.v_head_dim, d), ("heads", "embed")),
    }


def mla_attention(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # [B, T, d]
    positions: torch.Tensor,  # [B, T]
    cfg: ModelConfig,
    cache: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Absorbed-form MLA, as the reference: with q' = [q_nope W_uk |
    rope(q_rope)] and k' = [c | rope(k_rope)] the score is a single-KV-head
    attention in the (r + rd)-dim latent space with v' = c, so
    ``_sdpa_chunked`` is reused and the cache holds only c and k_rope."""
    m = cfg.mla
    h = cfg.num_heads
    dt = x.dtype
    b, t, _ = x.shape
    nd, rd, vd, r = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim, m.kv_lora_rank

    q = (x @ p["wq"].to(dt)).reshape(b, t, h, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    ckv = x @ p["w_dkv"].to(dt)  # [B, T, r + rd]
    c, k_rope = ckv[..., :r], ckv[..., r:]
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]

    if cache is not None:
        idx = cache["idx"]
        slots = idx.long() + torch.arange(t, device=x.device)
        cc = cache["c"].index_copy_(1, slots, c.to(cache["c"].dtype))
        ck = cache["k_rope"].index_copy_(1, slots, k_rope.to(cache["k_rope"].dtype))
        new_cache = {"c": cc, "k_rope": ck, "idx": idx.add_(t)}
        c, k_rope = cc.to(dt), ck.to(dt)
        q_positions = slots
    else:
        new_cache = None
        q_positions = torch.arange(t, device=x.device)

    q_lat = torch.einsum("bthn,rhn->bthr", q_nope, p["w_uk"].to(dt).reshape(r, h, nd))
    q_prime = torch.cat([q_lat, q_rope], dim=-1)  # [B, T, H, r + rd]
    k_prime = torch.cat([c, k_rope], dim=-1)[:, :, None, :]  # [B, S, 1, r + rd]
    ctx = _sdpa_chunked(
        q_prime, k_prime, c[:, :, None, :], 1.0 / math.sqrt(nd + rd), q_positions=q_positions,
    ).reshape(b, t, h, r)
    out = torch.einsum("bthr,rhv->bthv", ctx, p["w_uv"].to(dt).reshape(r, h, vd))
    return out.reshape(b, t, h * vd) @ p["wo"].to(dt), new_cache


def mla_cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    m = cfg.mla
    return {
        "c": ShapeDtype((batch, max_len, m.kv_lora_rank), torch.bfloat16),
        "k_rope": ShapeDtype((batch, max_len, m.qk_rope_head_dim), torch.bfloat16),
        "idx": ShapeDtype((), torch.int32),
    }
