"""Shared model machinery: spec-carrying parameters, norms, RoPE.

The counterpart of ``repro.models.common``.  Parameters are declared
as ``ParamInfo`` leaves (shape + logical axes + initializer + dtype) in
nested dicts; ``materialize`` turns such a tree into tensors and
``abstract`` into ``ShapeDtype`` leaves.  The logical axes map to mesh
axes through ``partition_specs`` (and ``distributed.sharding``'s
``param_pspecs``).

``remat_wrap`` and the cross-entropy losses serve training: the
policies ``full`` and ``dots`` are ``torch.utils.checkpoint`` (all of a
block recomputed in the backward pass, or all but its matmul outputs),
applied only while gradients are recorded.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.utils import checkpoint as _ckpt

from ..distributed.sharding import constrain


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


def materialize(tree: ParamTree, generator: torch.Generator, device=None,
                then: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None) -> ParamTree:
    """Tensors for a ParamInfo tree, drawn from ``generator`` leaf by leaf
    in sorted key order, on ``device`` (the generator's device by
    default), in each leaf's dtype.  The reference's rules: a fan-in
    scaled normal, ``embed`` x 0.02, ``small`` x 0.006, zeros and ones.
    The numbers differ from ``jax.random``'s; carry the reference's
    weights with ``convert`` to compare the two packages.  ``then(name,
    tensor)``, where given, replaces each leaf as soon as it is drawn (a
    shard of it), so the whole tree is never held at once."""
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

    return map_tree(leaf if then is None else (lambda name, i: then(name, leaf(name, i))), tree)


def abstract(tree: ParamTree) -> ParamTree:
    """The ``ShapeDtype`` of every ParamInfo leaf (no storage)."""
    return map_tree(lambda _, i: ShapeDtype(tuple(i.shape), i.dtype), tree)


def partition_specs(tree: ParamTree, rules: Dict[str, Any]) -> ParamTree:
    """Map logical axes to mesh axes: each ParamInfo leaf's spec, a tuple
    with one entry per dim.  ``rules[axis]`` may be a mesh axis name, a
    tuple of mesh axes, or None."""
    return map_tree(lambda _, info: tuple(rules.get(a) if a is not None else None
                                          for a in info.axes), tree)


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


# ----------------------------------------------------------------------
# training: rematerialisation and the token cross-entropy
# ----------------------------------------------------------------------
# the matmuls whose outputs the ``dots`` policy keeps: products with no
# batch dimension, as ``dots_with_no_batch_dims_saveable`` keeps them
# (``x @ W`` with a 3-d x reaches autograd as ``mm``)
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(fn: Callable, policy: str) -> Callable:
    """``fn`` under the reference's remat policy: ``none`` keeps every
    activation, ``full`` keeps only the inputs and recomputes the rest
    in the backward pass, ``dots`` keeps the outputs of the products
    with no batch dimension as well.  All three give the same gradients.
    Without gradients (``torch.no_grad``, serving) ``fn`` runs as it is."""
    if policy == "none":
        return fn
    if policy == "full":
        kw = {}
    elif policy == "dots":
        kw = {"context_fn": functools.partial(_ckpt.create_selective_checkpoint_contexts,
                                              _dots_policy)}
    else:
        raise ValueError(f"unknown remat policy {policy}")

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        # the blocks draw no random numbers, so no rng state is kept
        return _ckpt.checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)

    return wrapped


def _sharded_lse_ll(logits, labels):
    """(logsumexp, the label's logit) of vocab-sharded logits [..., V]:
    the vocab-parallel cross-entropy, each from local partial sums that
    meet in one reduction (a gather by label has no sharding rule over a
    sharded vocab)."""
    m = constrain(logits.detach().amax(-1, keepdim=True), ("batch", None))
    lse = constrain((logits - m).exp().sum(-1), ("batch",)).log() + m[..., 0]
    cols = torch.arange(logits.shape[-1], device=logits.device)
    ll = constrain(torch.where(cols == labels[..., None], logits, 0.0).sum(-1), ("batch",))
    return lse, ll


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, z_weight: float = 0.0) -> torch.Tensor:
    """Token cross-entropy with optional z-loss; logits [..., V], in
    float32."""
    logits = logits.float()
    if isinstance(logits, DTensor):
        lse, ll = _sharded_lse_ll(logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = lse - ll
    if z_weight:
        loss = loss + z_weight * lse.square()
    return loss


def chunked_softmax_xent(
    x: torch.Tensor,  # [B, T, d] final hidden states
    head: torch.Tensor,  # [d, V_padded]
    labels: torch.Tensor,  # [B, T]; -1 = ignore
    logit_scale: float = 1.0,
    chunk: int = 16_384,
    n_vocab: int = 0,  # real vocab; padded columns >= n_vocab are masked
) -> torch.Tensor:
    """The mean cross-entropy of the labelled tokens without ever
    materialising [B, T, V] logits: the tokens go in chunks of
    ``min(chunk, B T)`` (the last padded with -1 labels), each under
    ``remat_wrap(..., "full")``, so at most one [chunk, V] float32
    logits block is alive, in the forward pass and in the backward.
    Padded vocabulary columns get -1e30.  Exact, as the reference's."""
    b, t, d = x.shape
    n = b * t
    xf = x.reshape(n, d)
    lf = labels.reshape(n)
    chunks = None
    if isinstance(xf, DTensor):  # each rank's own rows in chunks; one chunk not split
        chunks = _local_chunks(xf, lf, chunk) if xf.to_local().shape[0] > chunk else [(xf, lf)]
        chunk = n  # no padding: each rank's last chunk may be shorter
    chunk = min(chunk, n)
    pad = (-n) % chunk
    if pad:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, pad))
        lf = torch.nn.functional.pad(lf, (0, pad), value=-1)
    vpad = head.shape[-1]
    col_ok = None
    if n_vocab and n_vocab < vpad:
        col_ok = (torch.arange(vpad, device=x.device) < n_vocab)[None, :]

    def body(xs, ls, head):
        xs = constrain(xs, ("batch", None))
        logits = constrain((xs @ head.to(xs.dtype)).float() * logit_scale, ("batch", "vocab"))
        if col_ok is not None:
            logits = torch.where(col_ok, logits, -1e30)
        per = softmax_xent(logits, ls.clamp_min(0))
        mask = (ls >= 0).float()
        return (per * mask).sum(), mask.sum()

    body = remat_wrap(body, "full")
    loss_sum = count = None
    if chunks is None:
        chunks = zip(xf.split(chunk), lf.split(chunk)) if xf.shape[0] > chunk else [(xf, lf)]
    for xs, ls in chunks:
        s, c = body(xs, ls, head)
        loss_sum = s if loss_sum is None else loss_sum + s
        count = c if count is None else count + c
    if isinstance(loss_sum, DTensor):
        loss_sum, count = _reduced_together(loss_sum, count)
    return loss_sum / count.clamp_min(1.0)


def _local_chunks(xf: DTensor, lf: DTensor, chunk: int):
    """(hidden, labels) chunks of at most ``chunk`` of each rank's own rows
    of the row-sharded ``xf`` [n, d] and ``lf`` [n] (the same rows on the
    same rank): chunk j is every rank's j-th block, a DTensor of the same
    layout.  The loss sums over the chunks are the same sums; a split of
    the global rows would gather them."""
    xl, ll = xf.to_local(), lf.to_local()
    for j in range(0, xl.shape[0], chunk):
        yield (DTensor.from_local(xl[j:j + chunk], xf.device_mesh, xf.placements),
               DTensor.from_local(ll[j:j + chunk], lf.device_mesh, lf.placements))


def _reduced_together(a: DTensor, b: DTensor):
    """Two scalar DTensors (pending sums over the batch shards) reduced in
    one collective: the same loss and count on every rank."""
    mesh, pls = a.device_mesh, tuple(a.placements)
    if tuple(b.placements) != pls:
        b = b.redistribute(mesh, pls)
    both = DTensor.from_local(torch.stack([a.to_local(), b.to_local()]), mesh, pls,
                              run_check=False)
    both = both.redistribute(mesh, [Replicate()] * mesh.ndim)
    return both[0], both[1]
