"""Mesh construction: the counterpart of ``repro.launch.mesh``.

Single pod: 16 x 16 = 256 ranks, axes (data, model).
Multi-pod:  2 x 16 x 16 = 512 ranks, axes (pod, data, model) -- the
``pod`` axis is outermost data parallelism over the inter-pod links.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the initialized default process group, one rank per device, with
``mesh_dim_names`` the reference's axis names.  These functions never
start a group: the launcher (or ``torchrun``'s environment) does.
``make_elastic_mesh`` builds the largest (data, model) grid over the
world size -- elastic scaling: checkpoints are topology-agnostic (see
``checkpoint.manager``) so a job can restart on a shrunken fleet.
"""
from __future__ import annotations

import math
import os
from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError("initialize the default process group before building a mesh")
    return dist.get_world_size()


def _device_type(device_type: Optional[str]) -> str:
    if device_type is not None:
        return device_type
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh(shape, axes, device_type: Optional[str] = None):
    """A mesh of ``shape`` named ``axes`` over every rank of the default
    group, on ``device_type`` (default: ``cuda`` where there is a GPU).
    Raises unless the world size is the product of ``shape``, as
    ``jax.make_mesh`` raises when the devices are too few or too many."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    n = _world_size()
    if math.prod(shape) != n:
        raise ValueError(f"a mesh of shape {shape} needs {math.prod(shape)} ranks; the group has {n}")
    return init_device_mesh(_device_type(device_type), shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: Optional[str] = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_elastic_mesh(model_parallel: Optional[int] = None, device_type: Optional[str] = None):
    """Largest (data, model) grid over the ranks of the default group."""
    n = _world_size()
    if model_parallel is None:
        model_parallel = min(16, n)
        while n % model_parallel:
            model_parallel //= 2
    return make_mesh((n // model_parallel, model_parallel), ("data", "model"), device_type)


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size, in mesh order: the reference's ``mesh.shape``,
    which the spec functions of ``distributed.sharding`` read.  A mapping
    of axis sizes passes through, so the specs of a mesh can be asked for
    with no process group."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def describe(mesh) -> str:
    return f"mesh{mesh_shape(mesh)} over {mesh.size()} devices"


def parse_mesh(spec: str):
    """``--mesh``'s value: ``elastic`` -> None, ``DxM`` -> (D, M)."""
    if spec == "elastic":
        return None
    d, m = (int(x) for x in spec.split("x"))
    return d, m


def distributed_launch() -> bool:
    """Whether this process is one rank of a launch (``torchrun`` sets
    ``WORLD_SIZE``)."""
    return "WORLD_SIZE" in os.environ


def init_from_env(device: Optional[str] = None) -> torch.device:
    """Join the process group that ``torchrun``'s environment describes
    (``env://``) and return this rank's device: ``gloo`` on the CPU for
    ``--device cpu``; otherwise ``nccl``, one rank per card
    (``LOCAL_RANK``), raising when this host runs more ranks than it has
    cards.  No other backend is ever chosen in their place."""
    if device == "cpu":
        backend, dev = "gloo", torch.device("cpu")
    else:
        local = int(os.environ.get("LOCAL_RANK", 0))
        ranks = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", 1)))
        cards = torch.cuda.device_count()
        if ranks > cards:
            raise RuntimeError(
                f"{ranks} ranks on this host but {cards} GPU(s): NCCL takes one card per rank "
                "(gloo ranks on the CPU: --device cpu)"
            )
        torch.cuda.set_device(local)
        backend, dev = "nccl", torch.device("cuda", local)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
    return dev


def mesh_from_flag(spec: str, device_type: str):
    """The launchers' ``--mesh``: ``elastic`` or ``DxM`` over the ranks
    of the default group."""
    shape = parse_mesh(spec)
    if shape is None:
        return make_elastic_mesh(device_type=device_type)
    return make_mesh(shape, ("data", "model"), device_type)
