"""Optimizers and LR schedules: the counterpart of ``repro.train.optimizer``.

AdamW with decoupled weight decay, global-norm clipping, and the
schedules the recipes call for: cosine (default) and WSD
(warmup-stable-decay, the MiniCPM schedule).  The reference's formulas,
in float32, not ``torch.optim.AdamW``, which differs from them in three
ways: the clip scale is ``clip_norm / (gnorm + 1e-9)``, the rate is the
schedule at ``step + 1`` computed in float32, and the leaves that skip
weight decay are matched by substring on their lowercased ``/``-joined
path in the parameter tree.

Trees are nested dicts of tensors (the models' parameter trees).
``adamw_update`` updates the parameters and the moments in place, where
the reference's train step donates them, and returns them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..models.common import iter_leaves, map_tree


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32, 0-d
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # leaves whose path matches any of these substrings skip weight decay
    no_decay: tuple = ("norm", "bias", "b_", "ln_", "a_log", "dt_bias", "d_skip")


def _decay_mask(params, no_decay) -> Dict[str, Any]:
    """True for each leaf that takes weight decay: its ``/``-joined path,
    lowercased, contains none of ``no_decay``."""
    return map_tree(
        lambda name, _: not any(s in name.replace(".", "/").lower() for s in no_decay), params
    )


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares.  Over
    DTensor leaves: the norm over all shards (``sharded_global_norm``)."""
    if _sharded(tree):
        return sharded_global_norm(tree)
    return torch.sqrt(sum(x.float().square().sum() for _, x in iter_leaves(tree)))


def _sharded(tree) -> bool:
    return isinstance(next(iter_leaves(tree))[1], DTensor)


def sharded_global_norm(tree) -> torch.Tensor:
    """The global norm of a tree of DTensors as a plain 0-d float32 tensor,
    the same value on every rank: each rank sums the squares of its local
    shards -- a leaf replicated over a mesh dim counted only on that dim's
    first rank -- and one all-reduce over the default group (which the
    mesh spans) adds them."""
    total = None
    mesh = None
    for _, x in iter_leaves(tree):
        mesh = x.device_mesh
        coord = mesh.get_coordinate()
        local = x.to_local().float().square().sum()
        if any(c != 0 for c, pl in zip(coord, x.placements) if pl.is_replicate()):
            local = torch.zeros_like(local)
        total = local if total is None else total + local
    if mesh.size() != dist.get_world_size():
        raise ValueError("the sharded norm reduces over the default group: the mesh must span it")
    dist.all_reduce(total)
    return torch.sqrt(total)


def _local(tree):
    """Each DTensor leaf's local shard (sharing its storage)."""
    return map_tree(lambda _, x: x.to_local(), tree)


def adamw_init(params, cfg: AdamWConfig) -> AdamWState:
    device = next(iter_leaves(params))[1].device
    zeros = lambda: map_tree(lambda _, x: torch.zeros_like(x, dtype=torch.float32), params)  # noqa: E731
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device), mu=zeros(), nu=zeros())


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig):
    """One AdamW step: (params, new state, {"grad_norm", "lr"}), the
    parameters and moments updated in place.  The gradients are clipped
    to ``clip_norm`` by their global norm first."""
    gnorm = global_norm(grads)
    if _sharded(params):
        # the rest is elementwise: each rank updates its own shards in place
        grads, params_local = _local(grads), _local(params)
        state_local = AdamWState(step=state.step, mu=_local(state.mu), nu=_local(state.nu))
        _, new, om = _update(grads, state_local, params_local, cfg, gnorm)
        return params, AdamWState(step=new.step, mu=state.mu, nu=state.nu), om
    return _update(grads, state, params, cfg, gnorm)


def _update(grads, state: AdamWState, params, cfg: AdamWConfig, gnorm: torch.Tensor):
    # a true division (``float / tensor`` would multiply by a reciprocal)
    scale = torch.clamp_max(torch.full_like(gnorm, cfg.clip_norm) / (gnorm + 1e-9), 1.0)
    step = state.step + 1
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=stepf.device), stepf)
    lr = cfg.lr(step)
    mask = dict(iter_leaves(_decay_mask(params, cfg.no_decay)))
    mus, nus, gs = dict(iter_leaves(state.mu)), dict(iter_leaves(state.nu)), dict(iter_leaves(grads))
    for name, p in iter_leaves(params):
        g = gs[name].float() * scale
        m, v = mus[name], nus[name]
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g * (1 - b2) * g)
        del g
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        pf = p.float()
        if mask[name]:
            delta.add_(cfg.weight_decay * pf)
        p.copy_(pf - lr * delta)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), {"grad_norm": gnorm, "lr": lr}


# ----------------------------------------------------------------------
# schedules: functions of a 0-d integer step tensor, computed in float32
# ----------------------------------------------------------------------
def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).float()


def cosine_schedule(peak: float, warmup: int, total: int, floor: float = 0.1):
    def lr(step):
        step = _f32(step)
        warm = peak * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor * peak + (1 - floor) * peak * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return lr


def wsd_schedule(peak: float, warmup: int, stable: int, decay: int, floor: float = 0.01):
    """Warmup-Stable-Decay (MiniCPM): linear warmup, long flat stage,
    short exponential-ish decay to ``floor * peak``."""

    def lr(step):
        step = _f32(step)
        warm = peak * step / max(warmup, 1)
        in_decay = step - (warmup + stable)
        frac = torch.clamp(in_decay / max(decay, 1), 0.0, 1.0)
        log_floor = torch.log(torch.tensor(floor, dtype=torch.float32, device=step.device))
        dec = peak * torch.exp(log_floor * frac)
        out = torch.where(step < warmup, warm, torch.full_like(warm, peak))
        return torch.where(in_decay > 0, dec, out)

    return lr


def get_schedule(name: str, peak: float, total: int, warmup: Optional[int] = None):
    warmup = warmup if warmup is not None else max(total // 50, 10)
    if name == "cosine":
        return cosine_schedule(peak, warmup, total)
    if name == "wsd":
        decay = max(total // 10, 10)
        return wsd_schedule(peak, warmup, total - warmup - decay, decay)
    raise KeyError(name)
