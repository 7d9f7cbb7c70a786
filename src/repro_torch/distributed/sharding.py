"""Sharding rules: logical axes -> mesh specs -> DTensor placements.

The counterpart of ``repro.distributed.sharding``, with its spec logic
unchanged.  Parallelism layout:

* ``model`` axis: tensor parallel -- vocab, attention heads, FFN hidden,
  experts (expert parallelism), recurrent-state heads,
* ``data`` axis: batch data parallel + optional FSDP (parameter d_model
  dims sharded over data; ``gather_fsdp`` gathers a block's weights just
  before the block uses them, and the gradient leaves as a
  reduce-scatter back to the shard),
* ``pod`` axis (multi-pod mesh): outermost data parallel,
* long-context decode (batch 1): the KV/seq dimension of caches is
  sharded over ``data`` instead of batch (context parallelism).

A *spec* is the reference's ``PartitionSpec`` as a plain tuple, one entry
per tensor dim: a mesh axis name, a tuple of names (the dim sharded over
their product), or None; ``()`` replicates.  ``placements`` turns a spec
into DTensor placements, one per mesh dim.  The spec functions read only
the mesh's axis sizes (``launch.mesh.mesh_shape``), so they take a
``DeviceMesh`` or a mapping of axis sizes.

``constrain(x, axes)`` is the torch form of ``with_sharding_constraint``:
a no-op without rules (one device, the CPU tests), and under
``use_activation_rules(rules)`` a ``redistribute`` of a DTensor to the
placements the rules give its logical axes.
"""
from __future__ import annotations

import contextlib
import types
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

from ..launch.mesh import mesh_shape

Spec = Tuple[Any, ...]


def map_tree(fn, tree, prefix: str = ""):
    """``fn(dotted name, leaf)`` over a nested dict's leaves (the models'
    ``common.map_tree``; kept here so the models can import this module)."""
    return {
        k: map_tree(fn, v, f"{prefix}{k}.") if isinstance(v, dict) else fn(f"{prefix}{k}", v)
        for k, v in tree.items()
    }

# ----------------------------------------------------------------------
# activation sharding constraints
# ----------------------------------------------------------------------
# The rules are process-wide, not thread-local as the reference's: on a
# card, autograd runs the backward pass (and a remat block's recomputed
# forward) on its own device thread, which must see the rules the
# forward ran under.
_RULES = types.SimpleNamespace(rules=None)


def activation_rules(mesh, long_context: bool = False) -> Dict[str, Any]:
    b_ax = batch_axis(mesh)
    return {
        "mesh": mesh,
        "batch": None if long_context else b_ax,
        "seq": b_ax if long_context else None,
        "heads": "model",
        "experts": "model",
        "vocab": "model",
    }


@contextlib.contextmanager
def use_activation_rules(rules: Optional[Dict[str, Any]]):
    prev = _RULES.rules
    _RULES.rules = rules
    try:
        yield
    finally:
        _RULES.rules = prev


def current_rules() -> Optional[Dict[str, Any]]:
    return _RULES.rules


def _fits(dim: int, m, sizes: Dict[str, int]):
    """``m`` (a mesh axis, a tuple of them, or None) if it divides
    ``dim``, else None: indivisible dims stay replicated."""
    if m is None:
        return None
    total = 1
    for a in (m if isinstance(m, tuple) else (m,)):
        total *= sizes[a]
    return m if dim % total == 0 else None


def constrain(x, axes: Tuple[Optional[str], ...]):
    """Apply a sharding constraint by logical axis names (no-op when no
    rules are installed -- one device and the CPU tests -- or when ``x``
    is not a DTensor)."""
    rules = current_rules()
    if rules is None or not _is_dtensor(x):
        return x
    mesh = rules["mesh"]
    sizes = mesh_shape(mesh)
    names = tuple(_fits(dim, rules.get(a) if a else None, sizes) for dim, a in zip(x.shape, axes))
    want = placements(names, mesh)
    if tuple(x.placements) == want and not x.requires_grad:
        return x
    return _Constrain.apply(x, mesh, want)


class _Constrain(torch.autograd.Function):
    """``x.redistribute(mesh, want)`` whose gradient is put on ``want``
    too, as the transpose of ``with_sharding_constraint`` is the same
    constraint on the cotangent: a row-parallel output's all-reduce
    passes its gradient on replicated, and a gradient arriving partial
    at a constrained input meets in one all-reduce there.  (DTensor's own
    ``redistribute`` would put the gradient back on ``x``'s placements.)"""

    @staticmethod
    def forward(ctx, x, mesh, want):
        ctx.mesh, ctx.want = mesh, want
        return x.view_as(x) if tuple(x.placements) == want else x.redistribute(mesh, want)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.want:
            g = g.redistribute(ctx.mesh, ctx.want)
        return g, None, None


def _is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def data_axes(mesh) -> Tuple[str, ...]:
    sizes = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


# ----------------------------------------------------------------------
# specs -> placements
# ----------------------------------------------------------------------
def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that tensor dim ``d`` names, ``Replicate()`` on the others.
    A dim sharded over a tuple of axes is split over them in mesh order
    (the first named outermost), as a ``PartitionSpec`` splits it."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else ((entry,) if entry is not None else ())
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: the axes of a dim must come in mesh order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def _tree_placements(specs, mesh):
    return map_tree(lambda _, s: placements(s, mesh), specs)


# ----------------------------------------------------------------------
# parameter specs
# ----------------------------------------------------------------------
def param_rules(mesh, fsdp: bool = True) -> Dict[str, Any]:
    return {
        "vocab": "model",
        "heads": "model",
        "ff": "model",
        "experts": "model",
        "embed": "data" if (fsdp and "data" in mesh_shape(mesh)) else None,
        "lora": None,
        "layers": None,
        "state": None,
    }


def param_pspecs(abstract: Any, mesh, fsdp: bool = True) -> Any:
    """The spec of every ParamInfo leaf of ``abstract``: vectors and
    scalars replicated; each other dim on the mesh axis its logical axis
    names, unless the axis does not divide it or already shards another
    dim of the leaf."""
    rules = param_rules(mesh, fsdp)
    sizes = mesh_shape(mesh)

    def spec(_, info) -> Spec:
        if len(info.shape) <= 1:
            return ()
        names = []
        used = set()
        for dim, ax in zip(info.shape, info.axes):
            mesh_ax = rules.get(ax) if ax is not None else None
            if mesh_ax is not None and dim % sizes[mesh_ax] != 0:
                mesh_ax = None  # indivisible dims stay replicated
            if mesh_ax in used:
                mesh_ax = None  # a mesh axis shards at most one dim
            if mesh_ax is not None:
                used.add(mesh_ax)
            names.append(mesh_ax)
        return tuple(names)

    return map_tree(spec, abstract)


def param_shardings(abstract: Any, mesh, fsdp: bool = True) -> Any:
    return _tree_placements(param_pspecs(abstract, mesh, fsdp), mesh)


# ----------------------------------------------------------------------
# batch specs
# ----------------------------------------------------------------------
def batch_axis(mesh):
    """The mesh axis of a batch dim: ``data`` (or ``(pod, data)``), or None."""
    da = data_axes(mesh)
    return da if len(da) > 1 else (da[0] if da else None)


def batch_pspecs(batch_abstract: Dict[str, Any], mesh) -> Dict[str, Any]:
    b_ax = batch_axis(mesh)
    return map_tree(lambda _, s: (b_ax,) + (None,) * (len(s.shape) - 1), batch_abstract)


def batch_shardings(batch_abstract, mesh):
    return _tree_placements(batch_pspecs(batch_abstract, mesh), mesh)


# ----------------------------------------------------------------------
# cache specs (decode)
# ----------------------------------------------------------------------
_TRAILING = {
    # name -> (trailing_rank, trailing logical axes)
    ("k", 4): ("batch", "seq", "model", None),
    ("v", 4): ("batch", "seq", "model", None),
    ("k_rope", 3): ("batch", "seq", None),
    ("state", 4): ("batch", "model", None, None),
    ("conv", 3): ("batch", None, "model"),
    ("n", 3): ("batch", "model", None),
    ("n", 2): ("batch", "model"),
    ("c", 4): ("batch", "model", None, None),
    ("c", 2): ("batch", "model"),
    ("h", 2): ("batch", "model"),
    ("m", 2): ("batch", "model"),
    ("enc_out", 3): ("batch", None, None),
}


def _cache_leaf_spec(name: str, shape, sizes: Dict[str, int], sub: Dict[str, Any],
                     mla: bool = False) -> Spec:
    """The spec of one cache leaf named ``name`` (its last path
    component) of ``shape``: ``_TRAILING``'s logical axes on its trailing
    dims, ``sub`` mapping them to mesh axes."""
    if name == "idx" or name == "enc_len" or len(shape) == 0:
        return ()
    # mla latent cache: family-specific "c"
    if name == "c" and mla and len(shape) >= 3:
        trail = ("batch", "seq", None)
    else:
        trail = None
        for r in range(len(shape), 0, -1):
            if (name, r) in _TRAILING:
                trail = _TRAILING[(name, r)]
                break
        if trail is None:
            return ()
    lead = (None,) * (len(shape) - len(trail))
    names = [
        _fits(dim, sub.get(ax) if isinstance(ax, str) else ax, sizes)
        for dim, ax in zip(shape[len(lead):], trail)
    ]
    # KV caches dominate decode memory.  If the heads dim could not
    # take the model axis (kv heads not divisible by it), shard the
    # SEQ dim over "model" instead.
    used = {n for n in names if isinstance(n, str)} | {
        a for n in names if isinstance(n, tuple) for a in n
    }
    if "model" not in used and "seq" in trail:
        si = trail.index("seq")
        dim = shape[len(lead) + si]
        cur = names[si]
        cand = (
            ("model",) if cur is None
            else (cur + ("model",) if isinstance(cur, tuple) else (cur, "model"))
        )
        if _fits(dim, cand, sizes) is not None:
            names[si] = cand if len(cand) > 1 else "model"
    return lead + tuple(names)


def cache_pspecs(cfg, cache_abstract: Any, mesh, long_context: bool = False) -> Any:
    """Spec tree mirroring a cache tree.  ``long_context`` switches to
    context parallelism: seq over data, batch replicated."""
    sizes = mesh_shape(mesh)
    b_ax = batch_axis(mesh)
    sub = {
        "batch": None if long_context else b_ax,
        "seq": b_ax if long_context else None,
        "model": "model",
    }
    return map_tree(lambda path, s: _cache_leaf_spec(path.rsplit(".", 1)[-1], tuple(s.shape),
                                                     sizes, sub, cfg.mla is not None),
                    cache_abstract)


def state_placements(name: str, shape) -> tuple:
    """Under activation rules, the placements ``cache_pspecs`` gives a
    recurrent state leaf ``name`` of one layer's ``shape`` (a prefill
    makes its states without reading the caches, so their layout comes
    from the same table)."""
    rules = current_rules()
    mesh = rules["mesh"]
    sub = {"batch": rules["batch"], "seq": rules["seq"], "model": "model"}
    return placements(_cache_leaf_spec(name, tuple(shape), mesh_shape(mesh), sub), mesh)


def cache_shardings(cfg, cache_abstract, mesh, long_context=False):
    return _tree_placements(cache_pspecs(cfg, cache_abstract, mesh, long_context), mesh)


# ----------------------------------------------------------------------
# FSDP: a block's weights gathered over the data axes before use
# ----------------------------------------------------------------------
def gather_fsdp(tree):
    """Under activation rules, ``tree`` (a tensor or a tree of them) with
    every DTensor leaf its
    data-axis shards gathered (``Shard`` -> ``Replicate`` on the ``pod`` /
    ``data`` mesh dims; its ``model`` split kept): the all-gather GSPMD
    inserts before an FSDP weight's use.  Its gradient leaves as the
    matching reduce-scatter.  A no-op without rules."""
    rules = current_rules()
    if rules is None:
        return tree
    mesh = rules["mesh"]
    dims = [i for i, n in enumerate(mesh.mesh_dim_names) if n in ("pod", "data")]

    def gather(_, x):
        if not _is_dtensor(x) or all(not x.placements[i].is_shard() for i in dims):
            return x
        want = list(x.placements)
        for i in dims:
            want[i] = Replicate()
        return _GatherFSDP.apply(x, mesh, tuple(want))

    return map_tree(gather, tree) if isinstance(tree, dict) else gather("", tree)


class _GatherFSDP(torch.autograd.Function):
    """``x.redistribute(mesh, want)`` (the FSDP all-gather) whose gradient
    goes back to ``x``'s layout ``data`` first: the reduce-scatter onto
    the shard, then (a ``pod`` mesh's batch split) the shard's all-reduce
    over ``pod``, whatever order DTensor would pick."""

    @staticmethod
    def forward(ctx, x, mesh, want):
        ctx.mesh, ctx.placements = mesh, tuple(x.placements)
        return x.redistribute(mesh, want)

    @staticmethod
    def backward(ctx, g):
        names = ctx.mesh.mesh_dim_names
        first = tuple(ctx.placements[i] if names[i] == "data" else p
                      for i, p in enumerate(g.placements))
        for step in (first, ctx.placements):
            if tuple(g.placements) != step:
                g = g.redistribute(ctx.mesh, step)
        return g, None, None


# ----------------------------------------------------------------------
# recurrent blocks on each rank's rows
# ----------------------------------------------------------------------
# A recurrent block (mLSTM, sLSTM, Mamba2) runs on local tensors: each
# rank takes its own batch rows (the residual stream's layout) and the
# weights it needs whole, and computes either every head (replicated
# over ``model``) or its own heads (head-parallel, ``split``), where the
# outputs meet in one all-reduce.  The fused projections' splits
# (Mamba2's [z | x | B | C | dt], xLSTM's [x | z]) do not fall on the
# shard boundaries, so no DTensor rule can take them apart.
def model_dim(mesh) -> Optional[int]:
    names = list(mesh.mesh_dim_names)
    return names.index("model") if "model" in names else None


def rows_placements(x: DTensor) -> tuple:
    """The layout of a rank's own rows: ``x``'s batch shards kept, every
    other mesh dim whole."""
    return tuple(p if p.is_shard(0) else Replicate() for p in x.placements)


def wrap_local(t: torch.Tensor, mesh, placements, shape) -> DTensor:
    """A rank's local ``t`` as a DTensor of global ``shape`` (contiguous)
    on ``placements``, with no communication."""
    shape = torch.Size(shape)
    return DTensor.from_local(t, mesh, placements, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _on_model(pls, mesh, placement) -> tuple:
    mi = model_dim(mesh)
    return tuple(placement if i == mi else p for i, p in enumerate(pls))


def local_rows(x: DTensor, split: bool = False) -> torch.Tensor:
    """``x`` [B, ...] as this rank's rows, whole on every other dim (an
    all-gather or all-reduce where it is not).  Its gradient: the rows',
    partial over ``model`` when ``split`` (each model rank's heads
    contribute part of it)."""
    rows = rows_placements(x)
    mesh = x.device_mesh
    if tuple(x.placements) != rows:
        x = _Constrain.apply(x, mesh, rows) if any(p.is_partial() for p in x.placements) \
            else x.redistribute(mesh, rows)
    return x.to_local(grad_placements=_on_model(rows, mesh, Partial()) if split else rows)


def local_whole(w: DTensor, rows, split: bool = False) -> torch.Tensor:
    """A weight ``w`` whole on this rank (gathered over every mesh dim
    that shards it).  Its gradient is partial over the dims that split
    the rows (the batch) and, when ``split``, over ``model``; a
    reduce-scatter (or all-reduce) puts it back on ``w``'s layout."""
    mesh = w.device_mesh
    whole = (Replicate(),) * mesh.ndim
    if tuple(w.placements) != whole:
        w = w.redistribute(mesh, whole)
    grads = tuple(Partial() if p.is_shard() else Replicate() for p in rows)
    return w.to_local(grad_placements=_on_model(grads, mesh, Partial()) if split else grads)


def local_shard(w: DTensor, rows) -> torch.Tensor:
    """A weight gathered over the data axes (``gather_fsdp``) as its
    local ``model`` shard: its gradient partial over the batch dims."""
    mesh = w.device_mesh
    grads = tuple(Partial() if p.is_shard() else Replicate() for p in rows)
    return w.to_local(grad_placements=_on_model(grads, mesh, w.placements[model_dim(mesh)]))


def reduce_over_model(t: torch.Tensor, like: DTensor) -> torch.Tensor:
    """The sum over the ``model`` ranks of a local ``t`` (one all-reduce;
    its gradient is the gradient's all-reduce): a statistic of a
    head-parallel block over every head, as a norm over the whole
    hidden dim needs it."""
    mesh = like.device_mesh
    rows = rows_placements(like)
    pend = _on_model(rows, mesh, Partial())
    x = wrap_local(t, mesh, pend, (like.shape[0],) + tuple(t.shape[1:]))
    return _Constrain.apply(x, mesh, rows).to_local(grad_placements=pend)


def from_rows(t: torch.Tensor, like: DTensor, partial: bool = False) -> DTensor:
    """A rank's rows ``t`` [b, ...] as a DTensor in ``like``'s rows
    layout (a pending sum over ``model`` when ``partial``)."""
    mesh = like.device_mesh
    rows = rows_placements(like)
    return wrap_local(t, mesh, _on_model(rows, mesh, Partial()) if partial else rows,
                      (like.shape[0],) + tuple(t.shape[1:]))


def state_from_rows(name: str, t: torch.Tensor, like: DTensor, heads: int = 0) -> DTensor:
    """A recurrent state made from a rank's rows, on the layout
    ``state_placements`` gives it: whole over ``model`` (the local slice
    of its shard is taken, no communication), or, with ``heads``, already
    this rank's shard of its dim 1 of ``heads`` heads."""
    mesh = like.device_mesh
    rows = rows_placements(like)
    dims = [like.shape[0]] + list(t.shape[1:])
    if heads:
        dims[1] = heads
        rows = _on_model(rows, mesh, Shard(1))
    x = wrap_local(t, mesh, rows, dims)
    want = state_placements(name, x.shape)
    return x if tuple(x.placements) == want else x.redistribute(mesh, want)


def state_rows(c, like: DTensor, split: bool = False) -> torch.Tensor:
    """A cache state ``c`` [B, ...] as this rank's rows of ``like``, whole
    over ``model`` (with ``split``, this rank's shard of its dim 1, its
    heads); a plain tensor as it is."""
    if not _is_dtensor(c):
        return c
    want = rows_placements(like)
    if split:
        want = _on_model(want, like.device_mesh, Shard(1))
    if tuple(c.placements) != want:
        c = c.redistribute(c.device_mesh, want)
    return c.to_local()


def run_on_rows(fn, p, x: DTensor, cache=None):
    """``fn(p, x, cache)`` (a recurrent block on plain tensors: an output,
    or an output and its state dict) on this rank's rows with every
    weight whole and the cache's states whole over ``model``: the block
    replicated over ``model``, so no step of its recurrence needs a
    collective.  Returns the output in ``x``'s rows layout and the
    states on their cache layout."""
    rows = rows_placements(x)
    mesh = x.device_mesh
    pl = map_tree(lambda _, w: local_whole(w, rows) if _is_dtensor(w) else w, p)
    cl = None
    if cache is not None:
        cl = map_tree(lambda _, c: state_rows(c, x), cache)
    out = fn(pl, local_rows(x), cl)
    if not isinstance(out, tuple):
        return from_rows(out, x)
    y, state = out
    return from_rows(y, x), {k: state_from_rows(k, v, x) for k, v in state.items()}


# ----------------------------------------------------------------------
# placing values on a mesh
# ----------------------------------------------------------------------
def place_leaf(x, pl, mesh, device=None):
    """A DTensor with placements ``pl`` on ``mesh`` from ``x``: a DTensor
    is redistributed; a plain tensor or a numpy array is the global value,
    of which each rank keeps its own shard (no communication)."""
    if _is_dtensor(x):
        return x if tuple(x.placements) == tuple(pl) else x.redistribute(mesh, pl)
    device = device or mesh_device(mesh)
    t = distribute_tensor(torch.as_tensor(x).to(device), mesh, pl, src_data_rank=None)
    # the shard in storage of its own, so the full value can be freed
    return DTensor.from_local(t.to_local().clone(), mesh, pl, run_check=False,
                              shape=t.shape, stride=t.stride())


def place(tree, shardings, mesh, device=None):
    """``place_leaf`` over a tree (nested dicts, or an ``AdamWState``,
    whose step stays a plain tensor) and its placement tree.  A placed
    leaf keeps ``requires_grad``."""
    if hasattr(tree, "_fields"):  # an AdamWState: its step stays a plain tensor
        return type(tree)(step=tree.step, mu=place(tree.mu, shardings.mu, mesh, device),
                          nu=place(tree.nu, shardings.nu, mesh, device))
    if isinstance(tree, dict):
        return {k: place(v, shardings[k], mesh, device) for k, v in tree.items()}
    out = place_leaf(tree, shardings, mesh, device)
    if isinstance(tree, torch.Tensor) and tree.requires_grad and out is not tree:
        out = out.detach().requires_grad_()
    return out


def mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())
