"""Gradient compression for a cross-pod all-reduce: the counterpart of
``repro.train.grad_compress``.

int8 block-quantised gradients (blocks of 256, one float32 scale each)
with error feedback: each step the residual between the true gradient
and its quantised transport is carried locally and added back before
the next quantisation, so the compression bias telescopes away.  The
exchange across ranks of a ``(data, model)`` mesh waits for ROADMAP
13b; these are the per-rank transforms.  ``torch.round`` rounds half to
even, as ``jnp.round`` does.

    g_q, new_err = compress_with_feedback(grads, err)
    g_sync = all_reduce(decompress(g_q, grads)) / world_size
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from ..models.common import map_tree

BLOCK = 256


class Compressed(NamedTuple):
    q: Any  # int8 tree, each leaf [blocks, BLOCK]
    scale: Any  # float32 per-block scales, each leaf [blocks, 1]


def _blockify(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, BLOCK)


def _one(x: torch.Tensor):
    b = _blockify(x.float())
    scale = b.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(b / scale), -127, 127).to(torch.int8)
    return q, scale


def compress(tree) -> Compressed:
    pairs = map_tree(lambda _, x: _one(x), tree)
    return Compressed(q=map_tree(lambda _, qs: qs[0], pairs), scale=map_tree(lambda _, qs: qs[1], pairs))


def decompress(comp: Compressed, like) -> Any:
    """The float32 tree of ``like``'s shapes from ``comp``."""
    def one(name, ref):
        q, s = _get(comp.q, name), _get(comp.scale, name)
        return (q.float() * s).reshape(-1)[: ref.numel()].reshape(ref.shape)

    return map_tree(one, like)


def _get(tree, name: str):
    for part in name.split("."):
        tree = tree[part]
    return tree


def init_error(params) -> Any:
    return map_tree(lambda _, x: torch.zeros_like(x, dtype=torch.float32), params)


def compress_with_feedback(grads, error) -> Tuple[Compressed, Any]:
    """Quantise (grads + carried error); return compressed + new error."""
    corrected = map_tree(lambda name, g: g.float() + _get(error, name), grads)
    comp = compress(corrected)
    recon = decompress(comp, corrected)
    return comp, map_tree(lambda name, c: c - _get(recon, name), corrected)
