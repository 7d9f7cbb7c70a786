"""Step builders shared by the trainer and the server: the counterpart
of ``repro.launch.steps``.

On one device (``mesh=None``) ``build_train_step`` returns a
:class:`TrainStep`: microbatched gradient accumulation (the reference's
``n_micro`` rule; each micro-step's float32 gradients summed, then
divided by ``n_micro``), then ``adamw_update``.

On a mesh every builder returns a :class:`StepBundle`, the torch form of
GSPMD under ``param_pspecs``: each parameter, and its AdamW moments, is
a DTensor placed by its spec (FSDP: ``embed`` dims over ``data``; TP:
``heads`` / ``ff`` / ``vocab`` / ``experts`` over ``model``); the batch
is split over the data axes; the step runs the model's own code under
the reference's activation rules (``use_activation_rules``), where each
block gathers its weights over ``data`` first (``gather_fsdp``), the
row-parallel outputs meet in one all-reduce, the cross-entropy works on
vocab-sharded logits, and each weight's gradient leaves as a
reduce-scatter back to its shard.  A plain tensor that meets a DTensor
counts as replicated (``implicit_replication``: positions, masks).  The
bundle is SPMD: every rank of the mesh calls it with the same global
inputs, places its own shards (``place``: local slices, no
communication), and gets the results as DTensors.  Every family runs
on a mesh (the recurrent blocks on each rank's rows, ``sharding.run_on_rows``
and ``ssm._mamba_sharded``), on ``(data, model)`` or ``(pod, data,
model)``: the batch over the data axes, FSDP over ``data`` alone.  There
is no compiler to lower to: ``StepBundle.lower`` traces rank 0's step on
fake tensors instead (``launch.dryrun``) and returns its record.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..configs.base import ShapeConfig
from ..distributed.sharding import (
    batch_axis,
    activation_rules,
    batch_shardings,
    cache_shardings,
    param_shardings,
    place,
    place_leaf,
    placements,
    use_activation_rules,
)
from ..models import registry
from ..models.common import ShapeDtype, iter_leaves, map_tree
from ..train.optimizer import AdamWConfig, AdamWState, adamw_update, get_schedule
from .mesh import mesh_shape

METRICS = ("loss", "xent", "aux", "grad_norm", "lr")


def abstract_opt_state(params_abs) -> AdamWState:
    """The optimizer state's ``ShapeDtype`` tree for a parameter tree of
    ``ShapeDtype`` (``models.common.abstract``): float32 moments."""
    f32 = lambda: map_tree(lambda _, s: ShapeDtype(tuple(s.shape), torch.float32), params_abs)  # noqa: E731
    return AdamWState(step=ShapeDtype((), torch.int32), mu=f32(), nu=f32())


def n_micro_steps(global_batch: int, microbatch_seqs: int, dp: int = 1) -> int:
    """The reference's rule: ``global_batch // (dp * microbatch_seqs)``
    micro-steps (at least one), lowered until it divides the batch; ``dp``
    is the product of the mesh's data axes (``pod`` x ``data``), so each
    data shard sees ``microbatch_seqs`` sequences per micro-step."""
    n = max(1, global_batch // max(1, dp * microbatch_seqs))
    while global_batch % n:
        n -= 1
    return n


def restore_train_state(mgr, params, opt_state: AdamWState, step=None):
    """Resume a live model from ``mgr``'s checkpoint at ``step`` (default:
    the latest): each leaf of ``params`` (the model's own parameters) is
    overwritten in place, and the restored optimizer state is returned
    with the step, as ``(step, opt_state)``.  ``opt_state`` is the
    template of the state's shapes, dtypes and device."""
    step, state = mgr.restore({"params": params, "opt": opt_state._asdict()}, step)
    with torch.no_grad():
        for (_, p), (_, saved) in zip(iter_leaves(params), iter_leaves(state["params"])):
            p.copy_(saved)
    return step, AdamWState(**state["opt"])


@dataclasses.dataclass
class TrainStep:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    on one device: ``n_micro`` micro-steps of ``registry.loss`` over
    equal slices of the batch's leading axis, their gradients summed in
    float32 (in each parameter's ``.grad``) and divided by ``n_micro``,
    then one ``adamw_update`` in place.  The parameters must be float32
    leaves that require gradients (a trainable model's ``params()``).
    ``metrics``: ``loss`` (the mean over the micro-steps; ``xent`` is the
    same value, as in the reference), ``aux``, ``grad_norm`` and ``lr``,
    float32 0-d tensors."""

    cfg: Any
    n_micro: int
    opt_cfg: AdamWConfig

    def __call__(self, params, opt_state: AdamWState, batch: Dict[str, Any]):
        leaves = [p for _, p in iter_leaves(params)]
        for p in leaves:
            p.grad = None
        loss_sum = aux_sum = 0.0
        for i in range(self.n_micro):
            mb = {k: v.reshape((self.n_micro, v.shape[0] // self.n_micro) + v.shape[1:])[i]
                  for k, v in batch.items()}
            loss, metrics = registry.loss(self.cfg, params, mb)
            loss.backward()
            loss_sum = loss_sum + loss.detach()
            aux_sum = aux_sum + metrics["aux"].detach()
        with torch.no_grad():
            for p in leaves:
                p.grad.div_(self.n_micro)
        grads = map_tree(lambda _, p: p.grad, params)
        params, opt_state, om = adamw_update(grads, opt_state, params, self.opt_cfg)
        for p in leaves:
            p.grad = None
        loss = loss_sum / self.n_micro
        return params, opt_state, {"loss": loss, "xent": loss, "aux": aux_sum / self.n_micro, **om}


def _dp(mesh) -> int:
    sizes = mesh_shape(mesh)
    return int(np.prod([sizes.get(a, 1) for a in ("pod", "data")]))


def build_train_step(
    model: registry.Model,
    mesh,
    shape: ShapeConfig,
    lr: float = 3e-4,
    schedule: str = "cosine",
    total_steps: int = 10_000,
    fsdp: bool = True,
    microbatch_seqs: int = 2,
):
    """The reference's train step: the batch split so each data shard
    sees ``microbatch_seqs`` sequences per micro-step, AdamW on
    ``get_schedule(schedule, lr, total_steps)``.  ``mesh=None``: a
    :class:`TrainStep` on one device.  On a mesh: a :class:`StepBundle`
    whose ``fn(params, opt_state, batch)`` takes the model's parameters
    and the moments as DTensors (``place_params``, ``adamw_init``), and
    the global batch (numpy or tensors): micro-step ``i`` is the global
    rows ``[i b, (i + 1) b)``, as the reference's reshape makes it, and
    each rank places only its data shard of them."""
    opt_cfg = AdamWConfig(lr=get_schedule(schedule, lr, total_steps))
    if mesh is None:
        return TrainStep(cfg=model.cfg, n_micro=n_micro_steps(shape.global_batch, microbatch_seqs),
                         opt_cfg=opt_cfg)
    n_micro = n_micro_steps(shape.global_batch, microbatch_seqs, _dp(mesh))
    cfg = model.cfg
    batch_abs = model.batch_spec(shape)
    p_sh = param_shardings(model.abstract_params(), mesh, fsdp)
    o_sh = opt_state_shardings(p_sh, mesh)
    b_sh = batch_shardings(batch_abs, mesh)
    rules = activation_rules(mesh)

    def train_step(params, opt_state: AdamWState, batch):
        leaves = [p for _, p in iter_leaves(params)]
        for p in leaves:
            p.grad = None
        rows = {k: torch.as_tensor(v) for k, v in batch.items()}
        loss_sum = aux_sum = 0.0
        with sharded(rules):
            for i in range(n_micro):
                loss, aux = micro_step(cfg, params, micro_batch(rows, i, n_micro, b_sh, mesh))
                loss_sum = loss_sum + loss
                aux_sum = aux_sum + aux
            place_grads(leaves, n_micro)
            grads = map_tree(lambda _, p: p.grad, params)
            params, opt_state, om = adamw_update(grads, opt_state, params, opt_cfg)
        for p in leaves:
            p.grad = None
        loss = _plain(loss_sum / n_micro)
        return params, opt_state, {"loss": loss, "xent": loss, "aux": _plain(aux_sum / n_micro),
                                   **om}

    rep = placements((), mesh)
    return StepBundle(
        fn=train_step,
        args_abstract=(model.abstract_params(), abstract_opt_state(model.abstract_params()), batch_abs),
        in_shardings=(p_sh, o_sh, b_sh),
        out_shardings=(p_sh, o_sh, {k: rep for k in METRICS}),
        donate_argnums=(0, 1),
        mesh=mesh,
        n_micro=n_micro,
        opt_cfg=opt_cfg,
        cfg=cfg,
        kind="train",
    )


def micro_batch(rows: Dict[str, torch.Tensor], i: int, n_micro: int, b_sh, mesh):
    """Micro-step ``i``'s rows of the global batch ``rows`` (the global
    rows ``[i b, (i + 1) b)``, as the reference's reshape makes them),
    each rank placing its own data shard of them."""
    b = next(iter(rows.values())).shape[0] // n_micro
    return place({k: v[i * b:(i + 1) * b] for k, v in rows.items()}, b_sh, mesh)


def micro_step(cfg, params, mb):
    """One micro-step under the activation rules: ``registry.loss`` and
    its backward, each gradient accumulating in its parameter's ``.grad``
    (an FSDP shard's already reduce-scattered).  Returns (loss, aux),
    detached."""
    loss, metrics = registry.loss(cfg, params, mb)
    loss.backward()
    return loss.detach(), metrics["aux"].detach()


def place_grads(leaves, n_micro: int) -> None:
    """Every parameter's summed gradient on its own layout (the pending
    sums of a replicated leaf reduced), divided by ``n_micro``."""
    with torch.no_grad():
        for p in leaves:
            p.grad = _as_placed(p.grad, p).div_(n_micro)


# ----------------------------------------------------------------------
# the sharded bundles
# ----------------------------------------------------------------------
@contextlib.contextmanager
def sharded(rules):
    """The model's code on DTensors: the reference's activation rules
    installed, and plain tensors that meet a DTensor taken as replicated."""
    with use_activation_rules(rules), implicit_replication():
        yield


def opt_state_shardings(param_sh, mesh) -> AdamWState:
    return AdamWState(step=placements((), mesh), mu=param_sh, nu=param_sh)


def _is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def _plain(x):
    """A DTensor's full value as a plain tensor (a pending sum reduced;
    every rank calls this); a tensor as it is."""
    return x.full_tensor() if _is_dtensor(x) else x


def _as_placed(x, like):
    """``x`` (a DTensor, maybe ``Partial``) redistributed to ``like``'s
    placements: a gradient's pending sums reduced onto its parameter's
    layout (a reduce-scatter for an FSDP shard, an all-reduce for a
    replicated leaf)."""
    if tuple(x.placements) == tuple(like.placements):
        return x
    return x.redistribute(like.device_mesh, like.placements)


def place_params(model: registry.Model, mesh) -> None:
    """Re-place every parameter of ``model`` in place as a DTensor on
    ``mesh`` by ``param_pspecs``: each rank keeps its own shard of the
    values it holds (every rank must hold the same full values: a model
    built from the same seed, or loaded from the same weights).
    ``registry.build_model(..., mesh=)`` places each leaf as it is drawn
    instead, so no rank ever holds the whole model."""
    flat = dict(iter_leaves(param_shardings(model.abstract_params(), mesh)))
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        placed = place_leaf(p.detach(), flat[name], mesh)
        setattr(mod, leaf, torch.nn.Parameter(placed, requires_grad=p.requires_grad))


@dataclasses.dataclass
class StepBundle:
    """A step on a mesh: ``fn`` with the reference's abstract arguments
    and their placements (``in_shardings``, ``out_shardings``: trees of
    DTensor placements on ``mesh``).  ``bundle(*args)`` places each
    argument by its ``in_shardings`` first (a DTensor is redistributed if
    it must be; a plain array gives each rank its shard) and calls
    ``fn``; ``jit()`` is the bundle itself, as the reference's callers
    use it."""

    fn: Any
    args_abstract: Tuple
    in_shardings: Tuple
    out_shardings: Any
    donate_argnums: Tuple[int, ...] = ()
    mesh: Any = None
    n_micro: int = 1
    opt_cfg: Optional[AdamWConfig] = None
    placed_args: Tuple[int, ...] = (0, 1)
    cfg: Any = None
    kind: str = "train"

    def __call__(self, *args):
        args = tuple(
            place(a, s, self.mesh) if i in self.placed_args else a
            for i, (a, s) in enumerate(zip(args, self.in_shardings))
        ) + tuple(args[len(self.in_shardings):])
        return self.fn(*args)

    def jit(self):
        return self

    def lower(self) -> dict:
        """The bundle's dry-run record (``launch.dryrun.trace_bundle``):
        rank 0's step traced on fake tensors, nothing allocated, with its
        argument bytes, peak live bytes, FLOPs and collectives.  The torch
        form of the reference's ``lower()``: there is no XLA program, so
        the record takes the place of ``lower().compile()``'s analyses."""
        from .dryrun import trace_bundle

        return trace_bundle(self)


# ----------------------------------------------------------------------
# serving bundles
# ----------------------------------------------------------------------
def _token_placements(mesh, long_ctx: bool, rank: int):
    b_ax = None if long_ctx else batch_axis(mesh)
    return placements((b_ax,) + (None,) * (rank - 1), mesh)


def build_decode_step(model: registry.Model, mesh, shape: ShapeConfig, fsdp: bool = True,
                      hidden: bool = False) -> StepBundle:
    """One-token serve step with a KV cache of ``shape.seq_len``:
    ``fn(params, caches, tokens, positions) -> (logits, new caches)``.
    Long context (``global_batch`` below the data axis): the caches'
    seq dim over ``data``, the batch replicated, as the reference's.
    ``hidden``: the step stops at the final-normed hidden state
    (``hidden_step``, the private head's split point; the decoders
    only).  Every family: a decoder's KV or MLA caches, an
    encoder-decoder's self-attention caches beside its ``enc_out``, the
    recurrent states of xLSTM and Zamba2 (heads over ``model``)."""
    cfg = model.cfg
    if hidden and not registry.has_split_head(cfg):
        raise ValueError(f"{cfg.name}: the {cfg.family} family has no hidden_step")
    b = shape.global_batch
    long_ctx = b < mesh_shape(mesh).get("data", 1)
    rules = activation_rules(mesh, long_context=long_ctx)

    def serve_step(params, caches, tokens, positions):
        from ..models import lm

        step = lm.decoder_hidden_step if hidden else registry.decode_step
        with sharded(rules), torch.no_grad():
            out, new = step(cfg, params, tokens, caches, positions)
        return out, place(new, c_sh, mesh)

    cache_abs = model.cache_abstract(b, shape.seq_len)
    p_sh = param_shardings(model.abstract_params(), mesh, fsdp)
    c_sh = cache_shardings(cfg, cache_abs, mesh, long_context=long_ctx)
    tok_sh = _token_placements(mesh, long_ctx, 2)
    logits_sh = placements((None if long_ctx else batch_axis(mesh), None, "model"), mesh)
    tok_abs = ShapeDtype((b, 1), torch.int32)
    return StepBundle(
        fn=serve_step,
        args_abstract=(model.abstract_params(), cache_abs, tok_abs, tok_abs),
        in_shardings=(p_sh, c_sh, tok_sh, tok_sh),
        out_shardings=(logits_sh, c_sh),
        donate_argnums=(1,),
        mesh=mesh,
        placed_args=(0, 1, 2, 3),
        cfg=cfg,
        kind="decode",
    )


def build_prefill_step(model: registry.Model, mesh, shape: ShapeConfig, fsdp: bool = True) -> StepBundle:
    """``fn(params, batch, caches) -> (last logits, caches)``: the prompt
    written into the caches, batch over the data axes (which must divide
    it, as a ``jit`` argument sharded over them must).  Every family
    (``registry.prefill``)."""
    cfg = model.cfg
    b = shape.global_batch
    if b % _dp(mesh):
        raise ValueError(f"prefill batch {b} is not divisible by the data axes ({_dp(mesh)})")
    rules = activation_rules(mesh)

    def prefill_step(params, batch, caches):
        with sharded(rules), torch.no_grad():
            logits, new = registry.prefill(cfg, params, batch, caches)
        return logits, place(new, c_sh, mesh)

    batch_abs = model.batch_spec(shape)
    cache_abs = model.cache_abstract(b, shape.seq_len)
    p_sh = param_shardings(model.abstract_params(), mesh, fsdp)
    b_sh = batch_shardings(batch_abs, mesh)
    c_sh = cache_shardings(cfg, cache_abs, mesh, long_context=False)
    logits_sh = placements((batch_axis(mesh), None, "model"), mesh)
    return StepBundle(
        fn=prefill_step,
        args_abstract=(model.abstract_params(), batch_abs, cache_abs),
        in_shardings=(p_sh, b_sh, c_sh),
        out_shardings=(logits_sh, c_sh),
        donate_argnums=(2,),
        mesh=mesh,
        placed_args=(0, 1, 2),
        cfg=cfg,
        kind="prefill",
    )


def build_step(model: registry.Model, mesh, shape: ShapeConfig, **kw) -> StepBundle:
    if shape.kind == "train":
        return build_train_step(model, mesh, shape, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(model, mesh, shape)
    if shape.kind == "decode":
        return build_decode_step(model, mesh, shape)
    raise KeyError(shape.kind)
