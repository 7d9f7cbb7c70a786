"""Recurrent-family assemblies: xLSTM (ssm family) and Zamba2 (hybrid).

The counterpart of ``repro.models.hybrid``.  xLSTM groups its layers as
[1 sLSTM + (k-1) mLSTM] * G (``num_layers % slstm_every == 0``): the
sLSTM blocks are stacked along a leading ``[G]`` axis, the mLSTM blocks
along ``[G, k-1]``, and so are their caches.

Zamba2: a trunk of Mamba2 layers with ONE globally-shared
attention+MLP block applied before layers 0, k, 2k, ...
(``shared_attn_every``); each invocation has its own KV cache slice
(``idx`` too, stacked to ``[n_inv]``) and its own row of the low-rank
``lora`` stacks.  As in the reference, the LoRA term ``(h a_q) b_q`` is
added to the residual stream beside the attention output, not to q.

Both forwards return (logits | hidden, new caches): the reference's
third value is a zero auxiliary loss.  A decode step builds new caches
and leaves the caller's as they were.  The reference's ``constrain``
calls sit before each mLSTM block and each Mamba2 layer; its scans over
the stacks are Python loops over stacks unbound once (``lm._layers``).  The
reference's remat units run under ``remat_wrap(cfg.remat_policy)``: an
xLSTM group (its sLSTM block and the k-1 mLSTM blocks after it) and each
Mamba2 layer.  Without gradients (serving) the wrapper calls them
directly.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..configs.base import ModelConfig
from ..distributed.sharding import constrain
from .attention import gqa_attention, gqa_cache_spec, gqa_params
from .common import ParamInfo, ShapeDtype, map_tree, remat_wrap, rms_norm
from .ffn import mlp, mlp_params
from .lm import _embed_tokens, _layers, _logits, compute_dtype, stack_infos
from .ssm import mamba_cache_spec, mamba_decode_step, mamba_params, mamba_scan
from .xlstm import (
    mlstm_cache_spec,
    mlstm_decode_step,
    mlstm_params,
    mlstm_scan,
    slstm_cache_spec,
    slstm_decode_step,
    slstm_params,
    slstm_scan,
)


def _stack_specs(tree, *dims):
    return map_tree(lambda _, s: ShapeDtype(dims + s.shape, s.dtype), tree)


def _tokens(params, batch) -> torch.Tensor:
    return torch.as_tensor(batch["tokens"], device=params["embed"].device).long()


def _block(cfg, core_step, core_scan, pl, x, cache, decode: bool, prefill: bool):
    """One pre-norm residual block: (x + core(rms_norm(x)), its state
    or None)."""
    h = rms_norm(x, pl["ln"], cfg.norm_eps)
    if decode:
        out, state = core_step(pl["core"], h, cache, cfg)
    elif prefill:
        out, state = core_scan(pl["core"], h, cfg, return_state=True)
    else:
        out, state = core_scan(pl["core"], h, cfg), None
    return x + out, state


def _at(tree, *index):
    return map_tree(lambda _, a: a[index], tree)


class _Stacker:
    """New cache stacks filled layer by layer: each layer's state is
    copied into its slot as soon as it is made, so the step holds the
    old stacks, the new ones and one layer's state, not every layer's
    twice."""

    def __init__(self, dims, device):
        self.dims = dims
        self.device = device
        self.out: Optional[Dict[str, torch.Tensor]] = None

    def put(self, index, state: Dict[str, torch.Tensor]) -> None:
        if self.out is None:  # dtypes from the states (the compute dtype may promote them)
            self.out = {k: torch.empty(self.dims + tuple(v.shape), dtype=v.dtype, device=self.device)
                        for k, v in state.items()}
        for k, v in state.items():
            self.out[k][index] = v


# ----------------------------------------------------------------------
# xLSTM
# ----------------------------------------------------------------------
def xlstm_abstract(cfg: ModelConfig) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.padded_vocab
    k = cfg.xlstm.slstm_every
    if cfg.num_layers % k:
        raise ValueError(f"num_layers {cfg.num_layers} is not a multiple of slstm_every {k}")
    g = cfg.num_layers // k
    per_s = {"ln": ParamInfo((d,), ("embed",), init="ones"), "core": slstm_params(cfg)}
    per_m = {"ln": ParamInfo((d,), ("embed",), init="ones"), "core": mlstm_params(cfg)}
    return {
        "embed": ParamInfo((v, d), ("vocab", "embed"), init="embed"),
        "slstm": stack_infos(per_s, g),
        "mlstm": stack_infos(stack_infos(per_m, k - 1), g),
        "final_norm": ParamInfo((d,), ("embed",), init="ones"),
        "lm_head": ParamInfo((d, v), ("embed", "vocab")),
    }


def xlstm_forward(cfg: ModelConfig, params, batch, caches=None, positions=None,
                  head_mode: str = "full", prefill: bool = False):
    """(logits | hidden, new caches or None).  ``caches`` given without
    ``prefill`` is one decode step from them; ``prefill`` scans the
    tokens and returns the final states as the caches (the caches passed
    in are not read).  ``positions`` has no effect: the recurrence
    carries the order."""
    x = _embed_tokens(cfg, params, _tokens(params, batch), compute_dtype(cfg))
    decode = caches is not None and not prefill
    g, km = cfg.num_layers // cfg.xlstm.slstm_every, cfg.xlstm.slstm_every - 1
    new_s, new_m = _Stacker((g,), x.device), _Stacker((g, km), x.device)

    def group(xc, i, ps, pms):
        # a state is made only when decoding or prefilling (serving, without
        # gradients, where the wrapper calls this directly): each is copied
        # into its stack as soon as it is made
        cs = _at(caches["slstm"], i) if decode else None
        xc, state = _block(cfg, slstm_decode_step, slstm_scan, ps, xc, cs, decode, prefill)
        if state is not None:
            new_s.put(i, state)
        for j, pm in enumerate(pms):
            cm = _at(caches["mlstm"], i, j) if decode else None
            xc = constrain(xc, ("batch", "seq", None))
            xc, state = _block(cfg, mlstm_decode_step, mlstm_scan, pm, xc, cm, decode, prefill)
            if state is not None:
                new_m.put((i, j), state)
        return xc

    group = remat_wrap(group, cfg.remat_policy)
    groups = zip(_layers(params["slstm"]), map(_layers, _layers(params["mlstm"])))
    for i, (ps, pms) in enumerate(groups):
        x = group(x, i, ps, pms)
    new_caches = {"slstm": new_s.out, "mlstm": new_m.out} if (decode or prefill) else None
    return _logits(cfg, params, x, head_mode), new_caches


def xlstm_cache_abstract(cfg: ModelConfig, batch: int, max_len: int):
    """Stacked sLSTM ``[G, B, d_in]`` and mLSTM ``[G, k-1, ...]`` states,
    float32; ``max_len`` has no effect (the state has a fixed size)."""
    k = cfg.xlstm.slstm_every
    g = cfg.num_layers // k
    return {"slstm": _stack_specs(slstm_cache_spec(cfg, batch), g),
            "mlstm": _stack_specs(mlstm_cache_spec(cfg, batch), g, k - 1)}


# ----------------------------------------------------------------------
# Zamba2
# ----------------------------------------------------------------------
def _n_inv(cfg: ModelConfig) -> int:
    k = cfg.hybrid.shared_attn_every
    return (cfg.num_layers + k - 1) // k


def zamba_abstract(cfg: ModelConfig) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.padded_vocab
    n_inv, r = _n_inv(cfg), cfg.hybrid.lora_rank
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    per_m = {"ln": ParamInfo((d,), ("embed",), init="ones"), "core": mamba_params(cfg)}
    shared = {
        "ln_attn": ParamInfo((d,), ("embed",), init="ones"),
        "ln_mlp": ParamInfo((d,), ("embed",), init="ones"),
        "attn": gqa_params(cfg),
        "mlp": mlp_params(d, cfg.d_ff),
    }
    lora = {
        "a_q": ParamInfo((n_inv, d, r), (None, "embed", "lora"), init="small"),
        "b_q": ParamInfo((n_inv, r, h * hd), (None, "lora", "heads"), init="zeros"),
    }
    return {
        "embed": ParamInfo((v, d), ("vocab", "embed"), init="embed"),
        "mamba": stack_infos(per_m, cfg.num_layers),
        "shared": shared,
        "lora": lora,
        "final_norm": ParamInfo((d,), ("embed",), init="ones"),
        "lm_head": ParamInfo((d, v), ("embed", "vocab")),
    }


def _shared_block(cfg: ModelConfig, shared, lora, inv: int, x: torch.Tensor,
                  positions: torch.Tensor, cache_inv=None):
    """The shared attention+MLP block with invocation ``inv``'s LoRA row:
    (output, the invocation's cache, written in place, or None)."""
    dt = x.dtype
    h = rms_norm(x, shared["ln_attn"], cfg.norm_eps)
    delta_q = (h @ lora["a_q"][inv].to(dt)) @ lora["b_q"][inv].to(dt)
    attn, new_cache = gqa_attention(shared["attn"], h, positions, cfg, cache=cache_inv)
    x = x + attn + delta_q
    h = rms_norm(x, shared["ln_mlp"], cfg.norm_eps)
    return x + mlp(shared["mlp"], h), new_cache


def zamba_forward(cfg: ModelConfig, params, batch, caches=None, positions=None,
                  head_mode: str = "full", prefill: bool = False):
    """(logits | hidden, new caches or None).  The shared block fires
    before layers 0, k, 2k, ...; with caches each invocation writes its
    tokens into its own slice of a copy of ``caches["shared"]`` (a
    prefill too).  ``caches`` given without ``prefill`` is one decode
    step of the Mamba layers from ``caches["mamba"]``; ``prefill`` scans
    and returns the final Mamba states.  ``positions`` (numpy or a
    tensor; default ``arange(T)``) feed the shared attention's RoPE."""
    x = _embed_tokens(cfg, params, _tokens(params, batch), compute_dtype(cfg))
    decode = caches is not None and not prefill
    use_cache = caches is not None
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    else:
        positions = torch.as_tensor(positions, device=x.device)
    k = cfg.hybrid.shared_attn_every
    if cfg.num_layers % k:
        raise ValueError(f"num_layers {cfg.num_layers} is not a multiple of shared_attn_every {k}")
    new_shared = map_tree(lambda _, c: c.clone(), caches["shared"]) if use_cache else None
    new_mamba = _Stacker((cfg.num_layers,), x.device)
    layers = _layers(params["mamba"])

    def mamba(xc, i, pm):
        # as xLSTM's group: a state is made only when serving, without gradients
        cm = _at(caches["mamba"], i) if decode else None
        xc = constrain(xc, ("batch", "seq", None))
        xc, state = _block(cfg, mamba_decode_step, mamba_scan, pm, xc, cm, decode, prefill)
        if state is not None:
            new_mamba.put(i, state)
        return xc

    mamba = remat_wrap(mamba, cfg.remat_policy)
    for inv in range(cfg.num_layers // k):
        cache_inv = _at(new_shared, inv) if use_cache else None
        x, _ = _shared_block(cfg, params["shared"], params["lora"], inv, x, positions, cache_inv)
        for i in range(inv * k, (inv + 1) * k):
            x = mamba(x, i, layers[i])
    new_caches = None
    if use_cache or prefill:
        new_caches = {"shared": new_shared, "mamba": new_mamba.out}
    return _logits(cfg, params, x, head_mode), new_caches


def zamba_cache_abstract(cfg: ModelConfig, batch: int, max_len: int):
    """The shared block's KV caches stacked ``[n_inv]`` (bfloat16 K/V,
    int32 ``idx``) and the Mamba states stacked ``[num_layers]``
    (bfloat16, the reference's ``mamba_cache_spec``)."""
    return {
        "shared": _stack_specs(gqa_cache_spec(cfg, batch, max_len), _n_inv(cfg)),
        "mamba": _stack_specs(mamba_cache_spec(cfg, batch), cfg.num_layers),
    }

