"""Attention blocks: GQA with optional QKV bias (self- and
cross-attention), and MLA (DeepSeek-V2 latent attention with a
compressed KV cache).

The counterpart of ``repro.models.attention``: causal self-attention
with RoPE for the decoders, non-causal self-attention for the
encoder-decoder's encoder, and cross-attention (``kv_x``, no RoPE, a
key mask ``kv_valid``) for its decoder.  A KV cache is a preallocated
fixed-length buffer; ``gqa_attention`` and ``mla_attention`` write the
new tokens into the buffers they are given, in place, and return them
(the reference returns new arrays; ``lm._trunk`` and ``lm.decode_stack``
copy the caches once per step, so a caller's cache is left as it was).
q, k and v take the reference's ``constrain`` (heads over ``model``).
On DTensors the attention runs on each rank's shards, head-parallel and,
for a cache sharded along its sequence, sequence-parallel
(``_sharded_sdpa``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.distributed import _functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from ..configs.base import ModelConfig
from ..distributed.sharding import constrain
from .common import ParamInfo, ShapeDtype, apply_rope

_NEG = -1e30  # the reference's fill for masked scores


# ----------------------------------------------------------------------
# GQA
# ----------------------------------------------------------------------
def gqa_params(cfg: ModelConfig, cross: bool = False) -> Dict[str, ParamInfo]:
    """A cross-attention block (``cross``) has no QKV bias, even where
    ``cfg.qkv_bias`` gives one to self-attention."""
    d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    p = {
        "wq": ParamInfo((d, h * hd), ("embed", "heads")),
        "wk": ParamInfo((d, kv * hd), ("embed", "heads")),
        "wv": ParamInfo((d, kv * hd), ("embed", "heads")),
        "wo": ParamInfo((h * hd, d), ("heads", "embed")),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = ParamInfo((h * hd,), ("heads",), init="zeros")
        p["bk"] = ParamInfo((kv * hd,), ("heads",), init="zeros")
        p["bv"] = ParamInfo((kv * hd,), ("heads",), init="zeros")
    return p


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, t, _ = x.shape
    return _unshard(x, 2, lambda size: n % size != 0).reshape(b, t, n, -1)


def _unshard(x: torch.Tensor, dim: int, when=lambda size: True) -> torch.Tensor:
    """``x`` with ``dim`` gathered over each mesh dim that shards it (and
    of a size for which ``when`` holds); a plain tensor as it is.  The
    heads split of a projection whose heads the model axis does not
    divide (GSPMD replicates them), and the keys and values of a cache
    sharded along its sequence, which the chunked attention reads whole
    (DTensor has no rule for reshaping a sharded sequence into chunks)."""
    if not isinstance(x, DTensor):
        return x
    sizes = x.device_mesh.mesh.shape
    want = tuple(Replicate() if p.is_shard(dim) and when(sizes[i]) else p
                 for i, p in enumerate(x.placements))
    return x if want == tuple(x.placements) else x.redistribute(x.device_mesh, want)


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
    q_positions: Optional[torch.Tensor] = None,  # [Tq] absolute (None = not causal)
    kv_limit=None,  # scalar: keys >= limit invalid
    kv_valid: Optional[torch.Tensor] = None,  # [B|1, S] bool: extra key mask
    q_chunk: int = 512,
    k_chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over [qc, kc] blocks, the reference's:
    -1e30 for masked scores, a float32 running max, sum and accumulator,
    ``acc / max(l, 1e-30)`` at the end.  A key is masked past its
    query's position (``q_positions``; causal), at or past ``kv_limit``,
    and where ``kv_valid`` is false.  The reference's two ``scan``s are
    loops over the same chunks.

    On DTensors each rank attends on its local shards
    (``_sharded_sdpa``)."""
    kvh = k.shape[2]
    q = _unshard(q, 2, lambda size: kvh % size != 0)  # heads grouped per KV head
    if isinstance(q, DTensor):
        return _sharded_sdpa(q, k, v, scale, q_positions, kv_limit, kv_valid, q_chunk, k_chunk)
    return _sdpa_local(q, k, v, scale, q_positions, kv_limit, kv_valid, q_chunk, k_chunk)


def _sharded_sdpa(q, k, v, scale, q_positions, kv_limit, kv_valid, q_chunk, k_chunk):
    """``_sdpa_local`` on each rank's shards.  Head-parallel over the mesh
    dims that split q [B, Tq, H, hd] over its batch (dim 0) or heads
    (dim 2), with k and v split the same way (or, with one KV head, MLA,
    not over the heads): each rank attends over its own rows and heads.
    Sequence-parallel over the mesh dims that split k and v along their
    sequence (long context; KV heads the model axis does not divide): q
    is whole there, each rank attends over its own keys, and the partial
    softmaxes meet in three all-reduces (the running max, then the
    rescaled sums and accumulators), as the online softmax meets its
    next chunk.  DTensor's einsum and reshape rules cannot split a
    sharded head or sequence dim on every torch, so no rank gathers
    another's keys."""
    mesh = q.device_mesh

    def dims(t):
        return tuple(p.dim if p.is_shard() else ("partial" if p.is_partial() else None)
                     for p in t.placements)

    kd, vd = dims(k), dims(v)
    seq = [i for i in range(mesh.ndim) if kd[i] == 1]
    q = _unshard(q, 1, lambda size: True) if seq else q
    qd = dims(q)
    for i in range(mesh.ndim):
        ok = kd[i] == vd[i] and qd[i] in (None, 0, 2) and (
            kd[i] == qd[i] or (qd[i] == 2 and kd[i] is None and k.shape[2] == 1)
            or (kd[i] == 1 and qd[i] is None))
        if not ok:
            raise NotImplementedError(f"sharded attention: q on {q.placements}, k on "
                                      f"{k.placements}, v on {v.placements}")

    def whole(x):
        return x.full_tensor() if isinstance(x, DTensor) else x

    n = k.to_local().shape[1]
    lo = 0  # this rank's block of the keys, the outer mesh dim first
    for i in seq:
        lo = lo * mesh.mesh.shape[i] + mesh.get_local_rank(i)
    lo *= n
    q_positions, kv_limit = whole(q_positions), whole(kv_limit)
    if kv_valid is not None:
        kv_valid = whole(kv_valid)
        if kv_valid.shape[0] > 1:
            rows = [Shard(0) if d == 0 else Replicate() for d in qd]
            kv_valid = distribute_tensor(kv_valid, mesh, rows, src_data_rank=None).to_local()
        kv_valid = kv_valid[:, lo:lo + n]
    args = (q.to_local(), k.to_local(), v.to_local(), scale, q_positions, kv_limit, kv_valid,
            q_chunk, k_chunk)
    if not seq:
        out = _sdpa_local(*args)
    else:
        acc, m, l = _sdpa_local(*args, k_offset=lo, stats=True)
        top = m
        for i in seq:
            top = funcol.all_reduce(top, "max", (mesh, i))
        w = torch.exp(m - top)
        acc, l = acc * w[..., None], l * w
        for i in seq:
            acc = funcol.all_reduce(acc, "sum", (mesh, i))
            l = funcol.all_reduce(l, "sum", (mesh, i))
        b, tq, h = acc.shape[:3]
        out = (acc / torch.clamp_min(l, 1e-30)[..., None]).reshape(b, tq, -1).to(q.dtype)
    shape = torch.Size((q.shape[0], q.shape[1], q.shape[2] * v.shape[-1]))
    return DTensor.from_local(out, mesh, [Shard(d) if d is not None else Replicate() for d in qd],
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _sdpa_local(q, k, v, scale, q_positions, kv_limit, kv_valid, q_chunk, k_chunk,
                k_offset: int = 0, stats: bool = False):
    """The chunked attention on plain tensors; the keys are positions
    ``k_offset`` on.  ``stats``: the float32 accumulator [B, Tq, H, hd_v],
    running max and sum [B, Tq, H] before the final division."""
    s, kvh = k.shape[1], k.shape[2]
    b, tq, h, hd = q.shape
    g = h // kvh
    hv = v.shape[-1]
    qc = _divisor_chunk(tq, q_chunk)
    kc = _divisor_chunk(s, k_chunk)
    nq, nk = tq // qc, s // kc
    dev = q.device

    qg = q.reshape(b, nq, qc, kvh, g, hd)
    kg = k.reshape(b, nk, kc, kvh, hd)
    vg = v.reshape(b, nk, kc, kvh, hv)
    qpos = None if q_positions is None else q_positions.reshape(nq, qc)
    kvv = None if kv_valid is None else kv_valid.reshape(-1, nk, kc)

    outs, ms, ls = [], [], []
    for iq in range(nq):
        qb = qg[:, iq]  # [b, qc, kv, g, hd]
        m = torch.full((b, kvh, g, qc), _NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((b, kvh, g, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kvh, g, qc, hv), dtype=torch.float32, device=dev)
        for ik in range(nk):
            kb = kg[:, ik]  # [b, kc, kv, hd]
            vb = vg[:, ik]
            sc = _dot_f32("bqkgd,bskd->bkgqs", qb, kb) * scale  # [b, kv, g, qc, kc]
            kpos = k_offset + ik * kc + torch.arange(kc, device=dev)
            mask = None
            if qpos is not None:
                mask = kpos[None, :] <= qpos[iq][:, None]  # [qc, kc]
            if kv_limit is not None:
                mask = _and(mask, kpos < kv_limit)
            if kvv is not None:
                mask = _and(mask, kvv[:, ik][:, None, None, None, :])
            if mask is not None:
                sc = torch.where(mask, sc, _NEG)
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + _dot_f32("bkgqs,bskd->bkgqd", p.to(vb.dtype), vb)
            m = m_new
        if stats:
            outs.append(acc.permute(0, 3, 1, 2, 4))  # [b, qc, kv, g, hv]
            ms.append(m.permute(0, 3, 1, 2))
            ls.append(l.permute(0, 3, 1, 2))
            continue
        out = acc / torch.clamp_min(l, 1e-30)[..., None]  # [b, kv, g, qc, hv]
        outs.append(out.permute(0, 3, 1, 2, 4))  # [b, qc, kv, g, hv]
    if stats:
        return (torch.stack(outs, dim=1).reshape(b, tq, h, hv),
                torch.stack(ms, dim=1).reshape(b, tq, h), torch.stack(ls, dim=1).reshape(b, tq, h))
    out = torch.stack(outs, dim=1).reshape(b, tq, h * hv)
    return out.to(q.dtype)


def _cache_write(buf: torch.Tensor, slots: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """``buf.index_copy_(1, slots, new)`` in ``buf``'s dtype, in place.  A
    DTensor buffer is written shard by shard: each rank copies the slots
    that fall in its own range of the sequence (all of them, unless the
    buffer is sharded along it: long context, or KV heads the model axis
    does not divide) into its local rows (DTensor has no in-place rule for
    ``index_copy_`` on every torch, nor for a write into a sharded dim)."""
    new = new.to(buf.dtype)
    if not isinstance(buf, DTensor):
        return buf.index_copy_(1, slots, new)
    mesh = buf.device_mesh
    whole = tuple(Replicate() if p.is_shard(1) else p for p in buf.placements)
    if tuple(new.placements) != whole:
        new = new.redistribute(mesh, whole)
    if isinstance(slots, DTensor):
        slots = slots.full_tensor()
    local, fresh = buf.to_local(), new.to_local()
    n, tq = local.shape[1], slots.shape[0]
    if n == buf.shape[1]:  # the sequence whole on this rank
        local.index_copy_(1, slots, fresh)
        return buf
    rank = 0  # this rank's block along the sequence, the outer mesh dim first
    for i, p in enumerate(buf.placements):
        if p.is_shard(1):
            rank = rank * mesh.mesh.shape[i] + mesh.get_local_rank(i)
    lo = rank * n
    along = (1, -1) + (1,) * (local.dim() - 2)  # a mask over dim 1
    # no data-dependent shapes (the dry-run traces this on fake tensors)
    if tq <= n:
        # the tq consecutive slots fall on distinct rows mod n: the ones in
        # this block take the new values, the others write their row back
        pos = slots - lo
        rows = pos.remainder(n)
        mine = ((pos >= 0) & (pos < n)).view(along)
        local.index_copy_(1, rows, torch.where(mine, fresh, local.index_select(1, rows)))
    else:  # each row of the block from the slot that falls on it, if one does
        k = lo + torch.arange(n, device=local.device) - slots[0]
        hit = ((k >= 0) & (k < tq)).view(along)
        local.copy_(torch.where(hit, fresh.index_select(1, k.clamp(0, tq - 1)), local))
    return buf


def _and(mask: Optional[torch.Tensor], more: torch.Tensor) -> torch.Tensor:
    return more if mask is None else mask & more


def _key_mask(kv_valid, device) -> torch.Tensor:
    """``kv_valid`` ([Tk] or [B, Tk] bool, numpy or tensor) as [B|1, Tk]."""
    kvv = torch.as_tensor(kv_valid, device=device)
    return kvv[None, :] if kvv.dim() == 1 else kvv


def gqa_attention(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # [B, T, d]
    positions: torch.Tensor,  # [B, T]
    cfg: ModelConfig,
    kv_x: Optional[torch.Tensor] = None,  # cross-attention source [B, Tk, d]
    cache: Optional[Dict[str, torch.Tensor]] = None,
    causal: bool = True,
    use_rope: bool = True,
    kv_valid=None,  # [Tk] or [B, Tk] bool
    impl: str = "chunked",
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """The reference's rules: k and v come from ``kv_x`` where it is
    given (in the dtype ``kv_x`` and the compute dtype promote to, as
    JAX promotes them); RoPE, under ``use_rope``, turns q at
    ``positions`` and k at ``positions``, or at ``arange(Tk)`` for a
    ``kv_x`` without a cache.  With a cache the T new tokens are written
    at ``cache["idx"]`` and attend causally over the valid prefix;
    ``causal`` and ``kv_valid`` then have no effect, as there."""
    h, kv = cfg.num_heads, cfg.num_kv_heads
    dt = x.dtype
    src = x if kv_x is None else kv_x
    st = torch.promote_types(src.dtype, dt)
    q = x @ p["wq"].to(dt)
    k = src.to(st) @ p["wk"].to(st)
    v = src.to(st) @ p["wv"].to(st)
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = constrain(_split_heads(q, h), ("batch", "seq", "heads", None))
    k = constrain(_split_heads(k, kv), ("batch", "seq", "heads", None))
    v = constrain(_split_heads(v, kv), ("batch", "seq", "heads", None))
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
    scale = 1.0 / math.sqrt(q.shape[-1])

    if cache is None:
        if use_rope:
            kpos = positions if kv_x is None else torch.arange(src.shape[1], device=x.device)[None, :]
            k = apply_rope(k, kpos, cfg.rope_theta)
        kvv = None if kv_valid is None else _key_mask(kv_valid, x.device)
        if impl == "naive":
            tq, tk = q.shape[1], k.shape[1]
            mask = None
            if causal:
                ar_k = torch.arange(tk, device=x.device)
                ar_q = torch.arange(tq, device=x.device)
                mask = (ar_k[None, :] <= ar_q[:, None])[None]
            if kvv is not None:
                mask = _and(mask, kvv[:, None, :])
            out = _sdpa_naive(q, k, v, mask, scale)
        else:
            out = _sdpa_chunked(q, k, v, scale, q_positions=positions[0] if causal else None,
                                kv_valid=kvv)
        return out @ p["wo"].to(dt), None

    # decode/prefill-with-cache: write T tokens at cache["idx"], attend
    # causally over the valid prefix (works for T == 1 and T == seq).
    idx = cache["idx"]
    if use_rope:
        k = apply_rope(k, positions, cfg.rope_theta)
    tq = q.shape[1]
    slots = idx.long() + torch.arange(tq, device=x.device)
    ck = _cache_write(cache["k"], slots, k)
    cv = _cache_write(cache["v"], slots, v)
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
        cc = _cache_write(cache["c"], slots, c)
        ck = _cache_write(cache["k_rope"], slots, k_rope)
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
