"""Collectives of ranks that share one card (gloo), in one place.

NCCL takes one card per rank, so ranks that share a card talk through
gloo, whose collectives on card tensors stage the payload through pinned
host memory.  On the H100 (torch 2.11, CUDA 12.8) the functional
all-gather that DTensor issues segfaults on a gloo group with card
tensors, where the plain ``torch.distributed`` collectives on the same
tensors run, and run faster than a copy of each payload to pageable
host memory around a host collective (``chip_smoke.py --only staging``;
PERF.md).  Every tensor the program holds stays on the card.

* ``host_collectives()``, while entered, replaces the functional
  collectives DTensor calls (all-gather, reduce-scatter, all-reduce, and
  its Shard-to-Shard all-to-all, which gloo lacks) with plain c10d
  collectives on the same tensors, and restores torch's own on exit.
  NCCL ranks never enter it.
* ``send_recv`` is the pipeline's hop: ``batch_isend_irecv`` on an NCCL
  group; gloo's point-to-point ops take host tensors, so on any other
  group the payload goes through the host.

Every collective here is a c10d one, so ``comm.CollectiveLog`` sees it
as it sees DTensor's functional collectives on NCCL.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch.distributed import _functional_collectives as funcol
from torch.distributed.distributed_c10d import _resolve_process_group
from torch.distributed.tensor import _collective_utils, placement_types

_OPS = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN, "product": dist.ReduceOp.PRODUCT}


def send_recv(y: torch.Tensor, to: int, frm: int, group) -> torch.Tensor:
    """Send ``y`` to global rank ``to`` and receive its like from ``frm``.
    NCCL sends a card's tensors from the card (``batch_isend_irecv``);
    gloo's point-to-point ops read and write host memory, so any other
    backend passes them through the host, one ``isend`` and one
    ``irecv``."""
    if dist.get_backend(group) == "nccl":
        out = torch.empty_like(y)
        ops = [dist.P2POp(dist.isend, y.contiguous(), to, group),
               dist.P2POp(dist.irecv, out, frm, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out
    out = torch.empty(y.shape, dtype=y.dtype)
    reqs = [dist.isend(y.cpu().contiguous(), to, group), dist.irecv(out, frm, group)]
    for req in reqs:
        req.wait()
    return out.to(y.device)


# ----------------------------------------------------------------------
# DTensor's functional collectives, as plain c10d ones
# ----------------------------------------------------------------------
def _group(group, tag: str = ""):
    return _resolve_process_group(funcol._resolve_group_name(group, tag))


def _all_gather_single(self: torch.Tensor, gather_dim: int, group, tag: str = "") -> torch.Tensor:
    pg = _group(group, tag)
    n = pg.size()
    x = self.detach().contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=pg)
    if gather_dim != 0:
        out = torch.cat(out.chunk(n, 0), dim=gather_dim)
    return out


def _reduce_scatter_single(self: torch.Tensor, reduceOp: str, scatter_dim: int, group,
                           tag: str = "") -> torch.Tensor:
    pg = _group(group, tag)
    n = pg.size()
    x = self.detach()
    if scatter_dim != 0:
        x = torch.cat(x.chunk(n, scatter_dim), dim=0)
    x = x.contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x, op=_OPS[reduceOp.lower()], group=pg)
    if reduceOp.lower() == "avg":
        out = out / n
    return out


def _all_reduce(self: torch.Tensor, reduceOp: str, group, tag: str = "") -> torch.Tensor:
    pg = _group(group, tag)
    out = self.detach().clone()
    dist.all_reduce(out, op=_OPS[reduceOp.lower()], group=pg)
    if reduceOp.lower() == "avg":
        out = out / pg.size()
    return out


def _shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's Shard(i) -> Shard(j): an all-gather and this rank's chunk
    (gloo has no all-to-all; DTensor's own CPU fallback)."""
    out = _all_gather_single(input, gather_dim, (mesh, mesh_dim))
    return out.chunk(mesh.size(mesh_dim), dim=shard_dim)[mesh.get_local_rank(mesh_dim)].contiguous()


_REPLACED = (
    (funcol, "all_gather_single", _all_gather_single),
    (funcol, "all_gather_tensor", _all_gather_single),
    (funcol, "reduce_scatter_single", _reduce_scatter_single),
    (funcol, "reduce_scatter_tensor", _reduce_scatter_single),
    (funcol, "all_reduce", _all_reduce),
    (_collective_utils, "shard_dim_alltoall", _shard_dim_alltoall),
    (placement_types, "shard_dim_alltoall", _shard_dim_alltoall),
)


@contextlib.contextmanager
def host_collectives():
    """DTensor's collectives in this process as plain c10d ones while
    entered (see the module docstring)."""
    saved = [(m, name, getattr(m, name)) for m, name, _ in _REPLACED if hasattr(m, name)]
    try:
        for m, name, fn in _REPLACED:
            if hasattr(m, name):
                setattr(m, name, fn)
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)
