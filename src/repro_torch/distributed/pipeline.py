"""GPipe-style pipeline parallelism over a mesh axis: the counterpart of
``repro.distributed.pipeline``.

Layers are split into S stages, stage ``s`` lives on the ranks at
coordinate ``s`` of the ``stage`` mesh dim, and micro-batches stream
through with point-to-point hops between stages (on that dim's group;
``staged.send_recv``), on the reference's rotating-buffer schedule: at
step k, stage s works on micro-batch (k - s); bubble = (S - 1) / (S - 1
+ M).  A stage skips the steps at which it holds no micro-batch (the
reference computes them and throws the result away; the outputs are the
same).

SPMD, as ``core.distributed``: every rank calls ``pipeline_forward``
with the same micro-batches, computes its own stage, and gets the last
stage's ``[M, ...]`` outputs back (one broadcast from the last stage),
as the reference's single controller does.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from . import staged
from .sharding import map_tree


def _own_stage(leaf, s: int, n_stages: int):
    """This rank's stage of a parameter leaf: a DTensor sharded over the
    stage dim is its local ``[1, ...]`` shard; a plain leaf with a leading
    ``[S]`` axis is its row ``s``."""
    if isinstance(leaf, DTensor):
        return leaf.to_local()[0]
    if leaf.shape[0] != n_stages:
        raise ValueError(f"a stage parameter has leading dim {leaf.shape[0]}, want {n_stages}")
    return leaf[s]


def pipeline_forward(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,  # leaves with a leading [S] stage axis (or stage-sharded DTensors)
    x_micro: torch.Tensor,  # [M, micro_batch, ...] micro-batches
    mesh,
    axis: str = "stage",
) -> torch.Tensor:
    """Run M micro-batches through S = the ``axis`` dim's size stages.

    ``stage_fn(params_s, x)`` applies one stage and keeps ``x``'s shape
    and dtype.  Each rank runs only its own stage's parameters.  Returns
    the ``[M, ...]`` outputs of the last stage, on every rank."""
    dim = list(mesh.mesh_dim_names).index(axis)
    n_stages = mesh.mesh.shape[dim]
    s = mesh.get_local_rank(dim)
    group = mesh.get_group(dim)
    m = x_micro.shape[0]
    params = map_tree(lambda _, a: _own_stage(a, s, n_stages), stage_params)
    to_next = dist.get_global_rank(group, (s + 1) % n_stages)
    from_prev = dist.get_global_rank(group, (s - 1) % n_stages)

    buf = torch.zeros_like(x_micro[0])  # the activation passed from stage s - 1
    outs = torch.zeros_like(x_micro)
    for k in range(m + n_stages - 1):
        j = k - s  # the micro-batch this stage holds at step k
        if 0 <= j < m:
            y = stage_fn(params, x_micro[j] if s == 0 else buf)
            outs[j] = y
        else:
            y = torch.zeros_like(buf)
        if n_stages > 1:
            # pass activations down the pipe: stage i -> i + 1 (a ring, as
            # the reference's ppermute; stage 0 ignores what it receives)
            buf = staged.send_recv(y, to_next, from_prev, group)
    if n_stages > 1:
        dist.broadcast(outs, dist.get_global_rank(group, n_stages - 1), group=group)
    return outs
