"""Decoder-only and encoder-decoder language models.

The counterpart of ``repro.models.lm``, for the dense and moe families
(GQA or MLA attention, an MLP or a token-choice MoE, deepseek-style
dense first layers), vlm (a decoder whose input is a prefix of
precomputed patch embeddings, the stub of the vision tower, then the
token embeddings) and encdec (an encoder over precomputed frame
embeddings, the stub of the speech frontend, and a text decoder with
cross-attention to it).  The trunk's parameters are
*stacked* along a leading ``layers`` axis as in the reference, so its
weights carry across one to one; a dense prologue layer ``i`` of an MoE
model is ``dense_layer_{i}`` beside the stack, as there.  Caches are
stacked the same way, with ``dense_{i}`` beside them.

Deliberate differences:

* ``_trunk`` is a Python loop over the dense prologue and the stacked
  layers (the reference scans the stack under ``scan_layers``; here it
  has no effect).  The stack is unbound once per forward (``_layers``),
  so under autograd the backward stacks the layers' gradients once
  instead of writing a zero-filled ``[L, ...]`` gradient per layer.
  Each stacked block runs under ``remat_wrap(cfg.remat_policy)`` when it
  has no cache (the loss path), as the reference's ``body``; the caches
  path (serving) is never wrapped.
* ``stored_infos`` keeps each weight that the reference casts to
  ``compute_dtype`` before every use in that dtype (the forward computes
  the same numbers from half the bytes); ``lm_head`` and a tied
  ``embed`` stay float32, as ``head_matrix`` reads them.  That includes
  the MoE router and expert stacks, which the reference also casts
  before each use.  A trainable model keeps every weight in float32
  (``param_dtype``), as the reference: the same casts give the same
  forward.
* ``decoder_forward`` returns two values.  The reference's third, the
  MoE auxiliary loss, only feeds ``decoder_loss``, which takes it from
  ``_decoder_hidden``.
* ``encode`` and ``decode_stack`` loop over their stacked layers as
  ``_trunk`` does; ``decode_stack`` copies the decoder's caches once per
  call, so a caller's caches are left as they were.

* Under sharding rules each block gathers its FSDP-sharded weights over
  the data axes first (``sharding.gather_fsdp``, where GSPMD inserts the
  gather), and so do the embedding and the head; the token lookup on a
  vocab-sharded table is ``_vocab_parallel_lookup`` (local rows, one
  reduction, and a gradient kept on the rank's rows).  Without rules
  both are the plain lookup.

The reference's ``constrain`` calls sit at its sites (the trunk's input,
each stacked block's input and output, each encoder and decoder block's
input).  The ssm and hybrid families are assembled in ``hybrid`` from
this module's embedding, head and stacking helpers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..configs.base import ModelConfig
from ..distributed.sharding import constrain, gather_fsdp
from .attention import (
    gqa_attention,
    gqa_cache_spec,
    gqa_params,
    mla_attention,
    mla_cache_spec,
    mla_params,
)
from .common import (
    ParamInfo,
    ShapeDtype,
    chunked_softmax_xent,
    iter_leaves,
    map_tree,
    remat_wrap,
    rms_norm,
)
from .ffn import mlp, mlp_params, moe_ffn, moe_params

PORTED_FAMILIES = ("dense", "moe", "vlm", "encdec", "ssm", "hybrid")

# the leaves the reference casts to float32 before each use (the xLSTM
# gate weights and biases, Mamba2's A and step bias): kept in float32
FLOAT32_LEAVES = frozenset({"w_if", "b_if", "w_gates", "r_gates", "b_gates", "a_log", "dt_bias"})


def _not_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise KeyError(f"{cfg.name}: unknown family {cfg.family!r}; the port has {PORTED_FAMILIES}")


def _dense_layers(cfg: ModelConfig):
    return sorted(set(cfg.moe.dense_layers)) if cfg.moe else []


def stack_infos(tree, n: int):
    return map_tree(
        lambda _, i: ParamInfo((n,) + i.shape, ("layers",) + i.axes, i.init, i.dtype), tree
    )


def _layers(stacked: Dict[str, Any]):
    """The per-layer parameter trees of a stacked tree, in order: each
    leaf unbound once along its leading axis."""
    n = next(iter_leaves(stacked))[1].shape[0]
    rows = map_tree(lambda _, a: _unbind(a), stacked)
    return [map_tree(lambda _, r: r[i], rows) for i in range(n)]


def _unbind(a: torch.Tensor):
    """``a.unbind(0)``.  A DTensor (its layers axis never sharded) is
    unbound shard by shard and each row rewrapped with its placements one
    dim down, so the backward stacks local gradients, each already on its
    row's layout (DTensor's own unbind would redistribute the rows'
    gradients to one layout before stacking them)."""
    if not isinstance(a, DTensor):
        return a.unbind(0)
    pls = tuple(Shard(p.dim - 1) if p.is_shard() else p for p in a.placements)
    return tuple(DTensor.from_local(r, a.device_mesh, pls, run_check=False, shape=a.shape[1:],
                                    stride=torch.empty(a.shape[1:], device="meta").stride())
                 for r in a.to_local().unbind(0))


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


# ----------------------------------------------------------------------
# decoder-only block
# ----------------------------------------------------------------------
def _block_infos(cfg: ModelConfig, moe_layer: bool) -> Dict[str, Any]:
    _not_ported(cfg)
    d = cfg.d_model
    p: Dict[str, Any] = {
        "ln_attn": ParamInfo((d,), ("embed",), init="ones"),
        "ln_mlp": ParamInfo((d,), ("embed",), init="ones"),
        "attn": mla_params(cfg) if cfg.mla else gqa_params(cfg),
    }
    if moe_layer and cfg.moe:
        p["moe"] = moe_params(cfg)
    else:
        ff = cfg.moe.d_ff_dense if (cfg.moe and cfg.moe.d_ff_dense) else cfg.d_ff
        p["mlp"] = mlp_params(d, ff)
    return p


def _scalar(value: float, dtype: torch.dtype) -> torch.Tensor:
    """A 0-d CPU tensor: the reference's ``jnp.asarray(value, dtype)``,
    rounded to ``dtype`` as there; usable with tensors on any device."""
    return torch.tensor(value, dtype=dtype)


def _block_apply(
    cfg: ModelConfig,
    p: Dict[str, Any],
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[Dict] = None,
) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """(output, the layer's cache, the MoE aux term: float32 0 for an
    MLP layer)."""
    p = gather_fsdp(p)
    res_scale = _scalar(cfg.scale_residual, x.dtype)
    # the column-parallel inputs: their gradients meet in one all-reduce
    h = constrain(rms_norm(x, p["ln_attn"], cfg.norm_eps), ("batch", "seq", None))
    attend = mla_attention if cfg.mla else gqa_attention
    attn_out, new_cache = attend(p["attn"], h, positions, cfg, cache=cache)
    # a row-parallel output meets in one all-reduce before the residual
    # add (DTensor would otherwise make the residual partial too)
    x = x + constrain(attn_out, ("batch", "seq", None)) * res_scale
    h = constrain(rms_norm(x, p["ln_mlp"], cfg.norm_eps), ("batch", "seq", None))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "moe" in p:
        ffn_out, aux = moe_ffn(p["moe"], h, cfg)
    else:
        ffn_out = mlp(p["mlp"], h)
    x = x + constrain(ffn_out, ("batch", "seq", None)) * res_scale
    return x, new_cache, aux


# ----------------------------------------------------------------------
# decoder-only model
# ----------------------------------------------------------------------
def decoder_abstract(cfg: ModelConfig) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.padded_vocab
    dense = _dense_layers(cfg)
    params: Dict[str, Any] = {
        "embed": ParamInfo((v, d), ("vocab", "embed"), init="embed"),
        "final_norm": ParamInfo((d,), ("embed",), init="ones"),
        "layers": stack_infos(_block_infos(cfg, moe_layer=True), cfg.num_layers - len(dense)),
    }
    for i in dense:
        params[f"dense_layer_{i}"] = _block_infos(cfg, moe_layer=False)
    if not cfg.tie_embeddings:
        params["lm_head"] = ParamInfo((d, v), ("embed", "vocab"))
    return params


def stored_infos(cfg: ModelConfig, infos: Dict[str, Any]) -> Dict[str, Any]:
    """``infos`` with the dtype each weight is kept in: ``compute_dtype``
    for every weight the reference casts to it before each use (the
    attention, MLP and MoE matrices, the router, the norm weights, an
    untied ``embed``; the encoder-decoder's encoder and decoder blocks
    and ``enc_norm``; xLSTM's ``w_up``, ``w_q`` / ``w_k`` / ``w_v``,
    ``w_down`` and ``norm_w``; Mamba2's ``w_in``, ``conv_w``, ``conv_b``,
    ``d_skip``, ``norm_w`` and ``w_out``; Zamba2's shared block and its
    LoRA ``a_q`` / ``b_q``), float32 for ``lm_head``, a tied ``embed``
    and every ``FLOAT32_LEAVES`` weight, which the reference casts to
    float32 (storing those in bfloat16 would change the numbers)."""
    dt = compute_dtype(cfg)
    keep = {"lm_head"} | ({"embed"} if cfg.tie_embeddings else set())

    def stored(name, info):
        if name in keep or name.rsplit(".", 1)[-1] in FLOAT32_LEAVES:
            return info
        return dataclasses.replace(info, dtype=dt)

    return map_tree(stored, infos)


def _trunk(
    cfg: ModelConfig,
    params: Dict[str, Any],
    x: torch.Tensor,
    positions: torch.Tensor,
    caches: Optional[Dict] = None,
):
    """Run all blocks: the dense prologue layers, then a loop over the
    stacked ``layers`` axis (the reference's scan; ``scan_layers`` has no
    effect here), each stacked block under ``remat_wrap(cfg.remat_policy)``
    as the reference's ``body`` (a plain call without gradients, so
    serving is never checkpointed).  The caches are copied once, and each
    layer writes its tokens into its own copy or its slice of the stacked
    copy: the caller's are left as they were.  Returns (x, new caches, the
    summed MoE aux terms)."""
    new_caches = None
    if caches is not None:
        new_caches = map_tree(lambda _, c: c.clone(), caches)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in _dense_layers(cfg):
        cl = None if caches is None else new_caches[f"dense_{i}"]
        x, _, aux = _block_apply(cfg, params[f"dense_layer_{i}"], x, positions, cl)
        aux_total = aux_total + aux

    def body(pl, xc, cl):
        xc = constrain(xc, ("batch", "seq", None))
        xo, _, aux = _block_apply(cfg, pl, xc, positions, cl)
        return constrain(xo, ("batch", "seq", None)), aux

    body = remat_wrap(body, cfg.remat_policy)
    for i, pl in enumerate(_layers(params["layers"])):
        cl = None if caches is None else {k: c[i] for k, c in new_caches["layers"].items()}
        x, aux = body(pl, x, cl)
        aux_total = aux_total + aux
    return x, new_caches, aux_total


def _head(cfg: ModelConfig, params) -> torch.Tensor:
    return gather_fsdp(params["embed"].T if cfg.tie_embeddings else params["lm_head"])


def _logits(cfg: ModelConfig, params, x, head_mode: str = "full"):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if head_mode == "none":
        return x
    if head_mode == "last":
        x = x[:, -1:]
    dt = x.dtype
    return (x @ _head(cfg, params).to(dt)) * _scalar(cfg.logit_scale, dt)


def _embed_tokens(cfg: ModelConfig, params, tokens, dtype):
    table = gather_fsdp(params["embed"])
    x = _vocab_parallel_lookup(table, tokens) if isinstance(table, DTensor) else table[tokens]
    x = constrain(x, ("batch", "seq", None)).to(dtype)
    return x * _scalar(cfg.scale_emb, dtype)


def _vocab_parallel_lookup(table: DTensor, tokens) -> DTensor:
    """``table[tokens]`` for a table [V, d] whose vocab rows are split
    over some mesh dims (``model``) and whole on the others: each rank
    looks up the tokens that fall in its own rows (zeros elsewhere), so
    the output is a pending sum over the vocab dims, which the caller's
    ``constrain`` reduces.  The gradient stays on the rank's rows: a
    pending sum over the dims that split the tokens (the batch over
    ``data``), which the FSDP gather's backward reduce-scatters onto the
    shard.  (DTensor's own embedding backward builds the whole [V, d]
    gradient on every rank.)  A table whole on every dim, or tokens split
    over a vocab dim, take DTensor's own rule."""
    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(torch.as_tensor(tokens, device=table.device), mesh,
                                    [Replicate()] * mesh.ndim, run_check=False)
    tab, tok = tuple(table.placements), tuple(tokens.placements)
    vocab = [i for i, p in enumerate(tab) if p.is_shard(0)]
    if not vocab or any(not tok[i].is_replicate() for i in vocab) or any(
            not (p.is_replicate() or p.is_shard(0)) for p in tab):
        return torch.nn.functional.embedding(tokens, table)
    grad = [p if p.is_shard() else (Partial() if tok[i].is_shard() else Replicate())
            for i, p in enumerate(tab)]
    local = table.to_local(grad_placements=grad)
    n = local.shape[0]
    lo = 0  # this rank's block of the vocab rows, the outer mesh dim first
    for i in vocab:
        lo = lo * mesh.mesh.shape[i] + mesh.get_local_rank(i)
    ids = tokens.to_local().long() - lo * n
    inside = (ids >= 0) & (ids < n)
    rows = torch.where(inside[..., None], local[ids.clamp(0, n - 1)], 0.0)
    shape = torch.Size(tuple(tokens.shape) + (table.shape[1],))
    return DTensor.from_local(rows, mesh, [Partial() if i in vocab else tok[i]
                                           for i in range(mesh.ndim)],
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _decoder_hidden(cfg: ModelConfig, params, batch, caches=None, positions=None):
    """The trunk's output before the final norm, the new caches and the
    summed MoE aux terms: ``decoder_forward``'s work up to ``_logits``."""
    _not_ported(cfg)
    dt = compute_dtype(cfg)
    dev = params["embed"].device
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    x = _embed_tokens(cfg, params, tokens, dt)
    if cfg.family == "vlm" and "patches" in batch:
        x = torch.cat([torch.as_tensor(batch["patches"], device=dev).to(dt), x], dim=1)
    if positions is None:
        positions = torch.arange(x.shape[1], device=dev).expand(x.shape[:2])
    else:
        positions = torch.as_tensor(positions, device=dev)
    x = constrain(x, ("batch", "seq", None))
    return _trunk(cfg, params, x, positions, caches)


def decoder_forward(
    cfg: ModelConfig,
    params: Dict[str, Any],
    batch: Dict[str, Any],
    caches: Optional[Dict] = None,
    positions=None,
    head_mode: str = "full",
):
    """Returns (logits | hidden, new_caches).  The reference's third
    value, the MoE auxiliary loss, feeds only ``decoder_loss`` and is not
    returned.  A vlm batch's ``patches`` [B, P, d] go before the token
    embeddings, in ``compute_dtype``; the default positions then span
    both.  ``batch["tokens"]``, ``batch["patches"]`` and ``positions``
    may be numpy arrays or tensors; they move to the parameters'
    device."""
    x, new_caches, _ = _decoder_hidden(cfg, params, batch, caches, positions)
    return _logits(cfg, params, x, head_mode), new_caches


def _labels(params, labels) -> torch.Tensor:
    return torch.as_tensor(labels, device=params["embed"].device).long()


def decoder_loss(cfg: ModelConfig, params, batch):
    """(the token cross-entropy of ``batch["labels"]`` plus the MoE aux
    term, {"xent", "aux"}), the reference's: a vlm's patch positions get
    -1 labels (ignored), and the head's padded columns are masked."""
    x, _, aux = _decoder_hidden(cfg, params, batch)
    hidden = _logits(cfg, params, x, head_mode="none")
    labels = _labels(params, batch["labels"])
    if cfg.family == "vlm" and "patches" in batch:
        pad = torch.full(tuple(batch["patches"].shape[:2]), -1, dtype=labels.dtype,
                         device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    loss = chunked_softmax_xent(hidden, _head(cfg, params), labels,
                                logit_scale=cfg.logit_scale, n_vocab=cfg.vocab_size)
    return loss + aux, {"xent": loss, "aux": aux}


def decoder_cache_abstract(cfg: ModelConfig, batch: int, max_len: int):
    _not_ported(cfg)
    per_layer = (mla_cache_spec if cfg.mla else gqa_cache_spec)(cfg, batch, max_len)
    dense = _dense_layers(cfg)
    n_scan = cfg.num_layers - len(dense)
    caches: Dict[str, Any] = {
        "layers": {k: ShapeDtype((n_scan,) + s.shape, s.dtype) for k, s in per_layer.items()}
    }
    for i in dense:
        caches[f"dense_{i}"] = dict(per_layer)
    return caches


def decoder_decode_step(cfg: ModelConfig, params, tokens, caches, positions):
    """One decode step: tokens [B, 1]; positions [B, 1] absolute."""
    return decoder_forward(cfg, params, {"tokens": tokens}, caches=caches, positions=positions)


def decoder_prefill(cfg: ModelConfig, params, batch, caches):
    """Prefill: write the prompt into the caches, return last logits."""
    return decoder_forward(cfg, params, batch, caches=caches, head_mode="last")


def decoder_hidden_step(cfg: ModelConfig, params, tokens, caches, positions):
    """One decode step stopping at the final-normed hidden state
    (``head_mode="none"``): tokens [B, 1] -> hidden [B, 1, d_model].

    The private-inference split point: the public trunk runs on the
    device up to here, and the lm-head matmul — the part multiplying the
    *private* head matrix — routes through the CMPC serving engine
    (``hidden @ head_matrix``) instead of the local ``_logits`` path.
    """
    return decoder_forward(
        cfg, params, {"tokens": tokens}, caches=caches, positions=positions, head_mode="none",
    )


def head_matrix(cfg: ModelConfig, params) -> torch.Tensor:
    """The lm-head weight [d_model, vocab] with ``logit_scale`` folded
    in, so ``hidden @ head_matrix(cfg, params)`` equals the full-head
    logits — the private source-2 operand the serving engine holds."""
    return _head(cfg, params) * _scalar(cfg.logit_scale, torch.float32)


# ----------------------------------------------------------------------
# encoder-decoder (seamless-style backbone; the modality frontend is a stub)
# ----------------------------------------------------------------------
def _enc_block_infos(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "ln_attn": ParamInfo((d,), ("embed",), init="ones"),
        "ln_mlp": ParamInfo((d,), ("embed",), init="ones"),
        "attn": gqa_params(cfg),
        "mlp": mlp_params(d, cfg.d_ff),
    }


def _dec_block_infos(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "ln_self": ParamInfo((d,), ("embed",), init="ones"),
        "ln_cross": ParamInfo((d,), ("embed",), init="ones"),
        "ln_mlp": ParamInfo((d,), ("embed",), init="ones"),
        "self_attn": gqa_params(cfg),
        "cross_attn": gqa_params(cfg, cross=True),
        "mlp": mlp_params(d, cfg.d_ff),
    }


def encdec_abstract(cfg: ModelConfig) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.padded_vocab
    return {
        "embed": ParamInfo((v, d), ("vocab", "embed"), init="embed"),
        "enc_layers": stack_infos(_enc_block_infos(cfg), cfg.enc_layers),
        "enc_norm": ParamInfo((d,), ("embed",), init="ones"),
        "dec_layers": stack_infos(_dec_block_infos(cfg), cfg.dec_layers),
        "final_norm": ParamInfo((d,), ("embed",), init="ones"),
        "lm_head": ParamInfo((d, v), ("embed", "vocab")),
    }


def _enc_block_apply(cfg: ModelConfig, pl, x: torch.Tensor, positions: torch.Tensor):
    h = rms_norm(x, pl["ln_attn"], cfg.norm_eps)
    attn, _ = gqa_attention(pl["attn"], h, positions, cfg, causal=False)
    x = x + attn
    h = rms_norm(x, pl["ln_mlp"], cfg.norm_eps)
    return x + mlp(pl["mlp"], h)


def encode(cfg: ModelConfig, params, frames) -> torch.Tensor:
    """frames: [B, Te, d] precomputed modality embeddings (the stub
    frontend; numpy or a tensor), in ``compute_dtype``, through the
    encoder's non-causal blocks and ``enc_norm``."""
    dev = params["embed"].device
    x = torch.as_tensor(frames, device=dev).to(compute_dtype(cfg))
    positions = torch.arange(x.shape[1], device=dev).expand(x.shape[:2])
    body = remat_wrap(
        lambda pl, xc: _enc_block_apply(cfg, pl, constrain(xc, ("batch", "seq", None)), positions),
        cfg.remat_policy)
    for pl in _layers(params["enc_layers"]):
        x = body(pl, x)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _dec_block_apply(cfg, pl, x, positions, enc_out, cache, enc_valid=None):
    """Causal self-attention with the cache, then cross-attention to
    ``enc_out`` (no RoPE, keys masked by ``enc_valid``, no cache: the
    reference projects ``enc_out`` again at every step), then the MLP."""
    h = rms_norm(x, pl["ln_self"], cfg.norm_eps)
    attn, new_cache = gqa_attention(pl["self_attn"], h, positions, cfg, cache=cache)
    x = x + attn
    h = rms_norm(x, pl["ln_cross"], cfg.norm_eps)
    cross, _ = gqa_attention(pl["cross_attn"], h, positions, cfg, kv_x=enc_out, causal=False,
                             use_rope=False, kv_valid=enc_valid)
    x = x + cross
    h = rms_norm(x, pl["ln_mlp"], cfg.norm_eps)
    return x + mlp(pl["mlp"], h), new_cache


def decode_stack(cfg: ModelConfig, params, tokens, enc_out, caches=None, positions=None,
                 head_mode: str = "full", enc_len=None):
    """The decoder over ``tokens`` [B, T] against ``enc_out`` [B, Te, d]:
    (logits | hidden, new caches ``{"layers": ...}`` or None).  With
    ``enc_len`` the keys of ``enc_out`` at or past it are masked (a
    cache's padded buffer).  ``tokens``, ``positions`` and ``enc_len`` may
    be numpy or tensors; they move to the parameters' device."""
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev).long()
    x = _embed_tokens(cfg, params, tokens, compute_dtype(cfg))
    if positions is None:
        positions = torch.arange(x.shape[1], device=dev).expand(x.shape[:2])
    else:
        positions = torch.as_tensor(positions, device=dev)
    enc_valid = None
    if enc_len is not None:
        enc_valid = torch.arange(enc_out.shape[1], device=dev) < torch.as_tensor(enc_len, device=dev)
    new_caches = None
    if caches is not None:
        new_caches = {"layers": {k: c.clone() for k, c in caches["layers"].items()}}
    body = remat_wrap(
        lambda pl, xc, cl: _dec_block_apply(cfg, pl, constrain(xc, ("batch", "seq", None)),
                                            positions, enc_out, cl, enc_valid)[0],
        cfg.remat_policy)
    for i, pl in enumerate(_layers(params["dec_layers"])):
        cl = None if caches is None else {k: c[i] for k, c in new_caches["layers"].items()}
        x = body(pl, x, cl)
    return _logits(cfg, params, x, head_mode), new_caches


def encdec_loss(cfg: ModelConfig, params, batch):
    """(the decoder's token cross-entropy against the encoded
    ``batch["frames"]``, {"xent", "aux": 0})."""
    enc_out = encode(cfg, params, batch["frames"])
    hidden, _ = decode_stack(cfg, params, batch["tokens"], enc_out, head_mode="none")
    loss = chunked_softmax_xent(hidden, _head(cfg, params), _labels(params, batch["labels"]),
                                logit_scale=cfg.logit_scale, n_vocab=cfg.vocab_size)
    return loss, {"xent": loss, "aux": torch.zeros((), dtype=torch.float32, device=loss.device)}


def encdec_cache_abstract(cfg: ModelConfig, batch: int, max_len: int):
    """The decoder's stacked self-attention caches (the reference's; the
    registry's ``Model`` adds ``enc_out`` and ``enc_len``)."""
    per_layer = gqa_cache_spec(cfg, batch, max_len)
    return {"layers": {k: ShapeDtype((cfg.dec_layers,) + s.shape, s.dtype)
                       for k, s in per_layer.items()}}
