"""Shared model machinery: spec-carrying parameters, norms, RoPE.

The counterpart of ``repro.models.common`` for the serving path.
Parameters are declared as ``ParamInfo`` leaves (shape + logical axes +
initializer + dtype) in nested dicts; ``materialize`` turns such a tree
into tensors.  The logical axes are kept so the declarations read as
the reference's, though one device shards nothing.

``partition_specs``, ``abstract``, ``remat_wrap`` and the cross-entropy
losses serve the mesh and training and are not ported yet (ROADMAP
item 13).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParamInfo:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones | embed | small
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """A leaf's shape and dtype with no storage (a cache declaration)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


ParamTree = Dict[str, Any]


def iter_leaves(tree: ParamTree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(dotted name, leaf) pairs in sorted key order, the order in which
    ``jax.tree.flatten`` visits a dict."""
    for key in sorted(tree):
        name = f"{prefix}{key}"
        if isinstance(tree[key], dict):
            yield from iter_leaves(tree[key], name + ".")
        else:
            yield name, tree[key]


def map_tree(fn, tree: ParamTree, prefix: str = "") -> ParamTree:
    """``fn(dotted name, leaf)`` over every leaf, keeping the nesting."""
    return {
        k: map_tree(fn, v, f"{prefix}{k}.") if isinstance(v, dict) else fn(f"{prefix}{k}", v)
        for k, v in tree.items()
    }


def materialize(tree: ParamTree, generator: torch.Generator, device=None) -> ParamTree:
    """Tensors for a ParamInfo tree, drawn from ``generator`` leaf by leaf
    in sorted key order, on ``device`` (the generator's device by
    default), in each leaf's dtype.  The reference's rules: a fan-in
    scaled normal, ``embed`` x 0.02, ``small`` x 0.006, zeros and ones.
    The numbers differ from ``jax.random``'s; carry the reference's
    weights with ``convert`` to compare the two packages."""
    device = generator.device if device is None else torch.device(device)

    def leaf(_, info: ParamInfo) -> torch.Tensor:
        if info.init == "zeros":
            return torch.zeros(info.shape, dtype=info.dtype, device=device)
        if info.init == "ones":
            return torch.ones(info.shape, dtype=info.dtype, device=device)
        arr = torch.randn(info.shape, generator=generator, dtype=info.dtype, device=device)
        if info.init == "embed":
            return arr.mul_(0.02)
        if info.init == "small":
            return arr.mul_(0.006)
        fan_in = info.shape[-2] if len(info.shape) >= 2 else info.shape[-1]
        return arr.div_(math.sqrt(max(fan_in, 1)))

    return map_tree(leaf, tree)


def count_params(tree: ParamTree) -> int:
    """Elements of a tree of ParamInfo, ShapeDtype or tensor leaves."""
    return sum(
        math.prod(x.shape) if isinstance(x, (ParamInfo, ShapeDtype)) else x.numel()
        for _, x in iter_leaves(tree)
    )


# ----------------------------------------------------------------------
# numerics: float32 inside, the input's dtype out, as the reference
# ----------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dtype) * w.to(dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # [hd/2]
    angles = positions[..., :, None].float() * freqs  # [..., seq, hd/2]
    sin = torch.sin(angles)[..., :, None, :]
    cos = torch.cos(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
