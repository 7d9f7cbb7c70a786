"""Feed-forward blocks: SwiGLU MLP and token-choice MoE.

The counterpart of ``repro.models.ffn``.  The MoE uses the reference's
sort-based capacity dispatch: (token, k) pairs are ordered by expert id,
ranked within their expert, dropped past capacity, placed into a dense
[groups, experts, capacity, d] buffer, run through batched expert
matmuls, and combined back with the router gates.

``route_noaux_tc`` is DeepSeek-V3's group-limited sigmoid route, which
the reference lacks; the private MoE layer (``core/moe.py``) routes
with it.

Deliberate differences, each giving the reference's numbers:

* *Top-k.* ``jax.lax.top_k`` puts the lower index first among equal
  values; ``torch.topk`` promises no order, so the top k come from a
  stable descending sort.
* *Buffer and combine without atomics.* The reference scatter-adds into
  the buffer and into the output.  Here each kept pair is written to its
  own slot (slots of kept pairs are distinct; dropped pairs go to a spare
  slot that is cut off), and the combine gathers each token's k pairs and
  sums them in a fixed order (``_combine``), so the result does not
  depend on the order in which a device's atomics land.

The reference's ``constrain`` calls sit at its sites: the experts over
``model`` (expert parallelism), or under ``expert_tp`` the FFN hidden
over ``model`` with the dispatch kept shard-local.  Without sharding
rules they do nothing.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.distributed.tensor import DTensor

from ..configs.base import ModelConfig
from ..distributed.sharding import constrain
from .common import ParamInfo


def mlp_params(d: int, ff: int) -> Dict[str, ParamInfo]:
    return {
        "w_gate": ParamInfo((d, ff), ("embed", "ff")),
        "w_up": ParamInfo((d, ff), ("embed", "ff")),
        "w_down": ParamInfo((ff, d), ("ff", "embed")),
    }


def mlp(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    return (
        torch.nn.functional.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
    ) @ p["w_down"].to(dt)


# ----------------------------------------------------------------------
# MoE
# ----------------------------------------------------------------------
def moe_params(cfg: ModelConfig) -> Dict[str, ParamInfo]:
    m = cfg.moe
    d, ffe = cfg.d_model, m.d_ff_expert
    e = m.num_experts
    e_ax = None if m.expert_tp else "experts"
    p = {
        "router": ParamInfo((d, e), ("embed", None), init="small"),
        "w_gate": ParamInfo((e, d, ffe), (e_ax, "embed", "ff")),
        "w_up": ParamInfo((e, d, ffe), (e_ax, "embed", "ff")),
        "w_down": ParamInfo((e, ffe, d), (e_ax, "ff", "embed")),
    }
    if m.num_shared_experts:
        p["shared"] = mlp_params(d, ffe * m.num_shared_experts)
    return p


def dispatch_shape(cfg: ModelConfig, n: int) -> Tuple[int, int, int]:
    """(groups, tokens per group, capacity per expert and group) for n
    tokens: ``dispatch_groups`` lowered until it divides n, as the
    reference lowers it."""
    m = cfg.moe
    g = max(1, m.dispatch_groups)
    while n % g:
        g -= 1
    ng = n // g
    return g, ng, int(max(1, (ng * m.num_experts_per_tok * m.capacity_factor) // m.num_experts))


def route(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(probs, gates, expert ids) from float32 router logits [..., e]:
    the softmax, its k largest values (lower expert id first among equal
    values, as ``jax.lax.top_k``) renormalised to sum to one, and their
    ids."""
    probs = torch.softmax(logits, dim=-1)
    top, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = top[..., :k]
    return probs, gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), eidx[..., :k]


def route_noaux_tc(
    logits: torch.Tensor, bias: torch.Tensor, k: int, n_group: int, topk_group: int,
    scaling: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gates, expert ids) of DeepSeek-V3's ``noaux_tc`` route from router
    logits [..., e]: sigmoid scores; the correction ``bias`` [e] added for
    the selection only; each of ``n_group`` groups scored by the sum of its
    two largest biased scores; the ``topk_group`` best groups kept; the
    ``k`` largest biased scores within them chosen.  The gates are the
    chosen experts' unbiased scores over their sum, times ``scaling``
    (``norm_topk_prob`` true, ``routed_scaling_factor``).

    Every selection is a stable descending sort, so the lower group or
    expert id comes first among equal scores.  The ids come back in
    ascending order, and the gates' denominator is added up in that
    order, one expert at a time, so that it does not depend on how a
    device's reduction is split.  Experts outside the kept groups are
    masked with -inf (the published code fills them with 0.0, which
    differs only where a kept expert's biased score is negative)."""
    scores = torch.sigmoid(logits)
    biased = scores + bias
    e = biased.shape[-1]
    per_group = e // n_group
    grouped = biased.unflatten(-1, (n_group, per_group))
    top2 = torch.sort(grouped, dim=-1, descending=True, stable=True).values
    group_scores = top2[..., 0] + top2[..., 1]
    kept = torch.sort(group_scores, dim=-1, descending=True, stable=True).indices[..., :topk_group]
    keep = torch.zeros_like(group_scores, dtype=torch.bool).scatter_(-1, kept, True)
    masked = biased.masked_fill(~keep.repeat_interleave(per_group, dim=-1), float("-inf"))
    chosen = torch.sort(masked, dim=-1, descending=True, stable=True).indices[..., :k]
    ids = torch.sort(chosen, dim=-1).values
    gates = torch.gather(scores, -1, ids)
    den = gates[..., 0]
    for j in range(1, k):
        den = den + gates[..., j]
    return gates / den[..., None] * scaling, ids


def dispatch(eidx: torch.Tensor, e: int, cap: int):
    """The reference's sort-based dispatch of the (token, k) pairs of
    each group, eidx [g, ng, k]: ``order`` (a stable argsort of the flat
    expert ids), and for each pair in that order its source token,
    whether it is kept (its rank within its expert below ``cap``), and
    its buffer slot (expert, rank); a dropped pair points at slot
    (e - 1, cap - 1) as in the reference."""
    g, ng, k = eidx.shape
    flat_e = eidx.reshape(g, ng * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, -1, order)
    counts = torch.zeros((g, e), dtype=torch.int64, device=eidx.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, dim=-1) - counts
    rank = torch.arange(ng * k, device=eidx.device) - torch.gather(offsets, -1, sorted_e)
    keep = rank < cap
    slot_e = torch.where(keep, sorted_e, e - 1)
    slot_c = torch.where(keep, rank, cap - 1)
    return order, order // k, keep, slot_e, slot_c


def _combine(pairs: torch.Tensor, order: torch.Tensor, k: int) -> torch.Tensor:
    """out [g, ng, d] from the gated pair outputs [g, ng*k, d] in
    ``order``: each token's k pairs gathered back and added to zero one
    at a time in ascending expert id, the order in which the reference's
    scatter-add meets them in its sorted pairs."""
    g, ng = order.shape[0], order.shape[1] // k
    back = torch.empty_like(order)
    back.scatter_(1, order, torch.arange(ng * k, device=order.device).expand(g, -1))
    # a token's experts are distinct and ``order`` sorts by expert id, so
    # its pairs' positions in ``order`` ascend with their expert ids
    by_expert = torch.sort(back.reshape(g, ng, k), dim=-1).values
    per_token = pairs[torch.arange(g, device=pairs.device)[:, None, None], by_expert]
    out = torch.zeros_like(per_token[:, :, 0])
    for j in range(k):
        out = out + per_token[:, :, j]
    return out


def _whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's full value as a plain tensor (the expert ids, for the
    global counts: DTensor has no rule for counting them); a tensor as it
    is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def _local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (differentiable); a tensor as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def _like(local: torch.Tensor, ref: torch.Tensor, shape) -> torch.Tensor:
    """``local`` as a DTensor of global ``shape`` laid out as ``ref`` (its
    groups over the data axes, whole on each rank of the others); plain
    when ``ref`` is plain."""
    if not isinstance(ref, DTensor):
        return local
    return DTensor.from_local(local, ref.device_mesh, ref.placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def moe_ffn(
    p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, T, d].  Returns (out, aux): aux is the Switch load-balance
    term, float32, over all tokens.  Pairs past an expert's capacity in
    their group contribute nothing, as in the reference.

    On DTensors the dispatch and the combine are group-local: each rank
    sorts, ranks and places the pairs of its own groups (the group dim
    over the data axes, ``xf``'s layout) on its local shards, and only
    the expert buffer meets the experts' layout (DTensor has no rules
    for the integer sort-and-scatter)."""
    m = cfg.moe
    dt = x.dtype
    b, t, d = x.shape
    n = b * t
    e, k = m.num_experts, m.num_experts_per_tok
    g, ng, cap = dispatch_shape(cfg, n)

    xf = constrain(x.reshape(g, ng, d), ("batch", None, None))
    logits = (xf @ p["router"].to(dt)).float()  # [g, ng, e]
    probs, gates, eidx = route(logits, k)

    # load-balance aux loss (Switch-style, global statistics)
    me = probs.mean((0, 1))
    ids = _whole(eidx).reshape(-1).long()  # a count of static shape (no bincount)
    ce = torch.zeros(e, dtype=torch.int64, device=ids.device).index_add_(
        0, ids, torch.ones_like(ids)).float() / (n * k)
    aux = m.router_aux_weight * e * torch.sum(me * ce)

    xl, gates, eidx = _local(xf), _local(gates), _local(eidx)
    gl = xl.shape[0]
    order, token_of, keep, slot_e, slot_c = dispatch(eidx, e, cap)
    gi = torch.arange(gl, device=x.device)[:, None]
    # kept pairs fill distinct slots; dropped ones go to slot e * cap,
    # which is cut off: the reference adds their zero contribution
    buf = torch.zeros((gl, e * cap + 1, d), dtype=dt, device=x.device)
    buf[gi, torch.where(keep, slot_e * cap + slot_c, e * cap)] = xl[gi, token_of]
    e_ax = None if m.expert_tp else "experts"
    buf = _like(buf[:, : e * cap].reshape(gl, e, cap, d), xf, (g, e, cap, d))
    buf = constrain(buf, ("batch", e_ax, None, None))

    # expert compute: expert parallel (experts over "model") or expert-TP
    # (FFN hidden over "model"; the dispatch stays shard-local)
    hidden = torch.nn.functional.silu(torch.einsum("gecd,edf->gecf", buf, p["w_gate"].to(dt)))
    hidden = hidden * torch.einsum("gecd,edf->gecf", buf, p["w_up"].to(dt))
    if m.expert_tp:
        hidden = constrain(hidden, ("batch", None, None, "heads"))
    out_buf = constrain(torch.einsum("gecf,efd->gecd", hidden, p["w_down"].to(dt)),
                        ("batch", e_ax, None, None))
    # the combine reads every expert of its groups: experts gathered
    # (a no-op under expert-TP, whose buffer is whole on each rank)
    out_buf = _local(constrain(out_buf, ("batch", None, None, None)))

    pair_gate = torch.gather(gates.reshape(gl, ng * k), -1, order).to(dt)
    gated = out_buf[gi, slot_e, slot_c] * torch.where(keep, pair_gate, 0.0)[..., None]
    out = constrain(_like(_combine(gated, order, k), xf, (g, ng, d)), ("batch", None, None))

    if "shared" in p:
        out = out + mlp(p["shared"], xf)
    return out.reshape(b, t, d), aux
