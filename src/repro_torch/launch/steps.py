"""Step builders for the trainer: the counterpart of
``repro.launch.steps``'s ``build_train_step`` on one device.

``build_train_step`` returns a :class:`TrainStep`: microbatched gradient
accumulation (the reference's ``n_micro`` rule; each micro-step's float32
gradients summed, then divided by ``n_micro``), then ``adamw_update``.
The sharded ``StepBundle``, its ``lower`` and the prefill and decode
bundles shard a model over a ``(data, model)`` mesh and wait for ROADMAP
13b.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..configs.base import ShapeConfig
from ..models import registry
from ..models.common import ShapeDtype, iter_leaves, map_tree
from ..train.optimizer import AdamWConfig, AdamWState, adamw_update, get_schedule

METRICS = ("loss", "xent", "aux", "grad_norm", "lr")


def abstract_opt_state(params_abs) -> AdamWState:
    """The optimizer state's ``ShapeDtype`` tree for a parameter tree of
    ``ShapeDtype`` (``models.common.abstract``): float32 moments."""
    f32 = lambda: map_tree(lambda _, s: ShapeDtype(tuple(s.shape), torch.float32), params_abs)  # noqa: E731
    return AdamWState(step=ShapeDtype((), torch.int32), mu=f32(), nu=f32())


def n_micro_steps(global_batch: int, microbatch_seqs: int) -> int:
    """The reference's rule on one device: ``global_batch //
    microbatch_seqs`` micro-steps (at least one), lowered until it
    divides the batch."""
    n = max(1, global_batch // max(1, microbatch_seqs))
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


def build_train_step(
    model: registry.Model,
    shape: ShapeConfig,
    lr: float = 3e-4,
    schedule: str = "cosine",
    total_steps: int = 10_000,
    microbatch_seqs: int = 2,
) -> TrainStep:
    """The reference's train step on one device: the batch split so
    each micro-step sees ``microbatch_seqs`` sequences, AdamW on
    ``get_schedule(schedule, lr, total_steps)``."""
    return TrainStep(
        cfg=model.cfg,
        n_micro=n_micro_steps(shape.global_batch, microbatch_seqs),
        opt_cfg=AdamWConfig(lr=get_schedule(schedule, lr, total_steps)),
    )
