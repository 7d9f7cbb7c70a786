"""The collectives a stretch of the program runs, and those the sharded
train step's design predicts from the spec tables.

``CollectiveLog`` is a dispatch mode that sees every collective while it
is entered, by one mechanism on every backend: the functional
collectives DTensor issues (NCCL ranks, CPU gloo ranks) and the c10d
collectives that ``distributed.staged`` runs on the host for gloo ranks
sharing a card, as well as plain ``torch.distributed`` calls (the
optimizer's norm, the pipeline's broadcast).  For each kind it counts
the calls, the bytes of their inputs and the bytes a rank sends,
ring-wise over its group of g: an all-gather (g-1) x its input, a
reduce-scatter (g-1)/g x its input, an all-reduce 2(g-1)/g x its input.

``design_collectives`` is what one micro-step of the sharded train step
(``launch.steps.build_train_step`` on a ``(data, model)`` or ``(pod,
data, model)`` mesh) should run, derived from ``param_pspecs`` and the
activation rules alone.
"""
from __future__ import annotations

import collections
import math
import traceback
from pathlib import Path
from typing import Dict

import torch
import torch.distributed as dist
from torch.distributed.distributed_c10d import _resolve_process_group
from torch.utils._python_dispatch import TorchDispatchMode

from .sharding import param_pspecs

# op name -> (kind, index of its input among the op's arguments)
_OPS = {
    "all_gather_into_tensor": ("all_gather", 0),  # _c10d_functional
    "reduce_scatter_tensor": ("reduce_scatter", 0),
    "all_reduce": ("all_reduce", 0),
    "broadcast": ("broadcast", 0),
    "_allgather_base_": ("all_gather", 1),  # c10d
    "_reduce_scatter_base_": ("reduce_scatter", 1),
    "allreduce_": ("all_reduce", 0),
    "broadcast_": ("broadcast", 0),
}


def sent_bytes(kind: str, nbytes: int, g: int) -> int:
    """Bytes a rank sends in one ring collective over a group of ``g``
    whose input on the rank is ``nbytes``."""
    return {"all_gather": (g - 1) * nbytes, "reduce_scatter": (g - 1) * nbytes // g,
            "all_reduce": 2 * (g - 1) * nbytes // g, "broadcast": nbytes}[kind]


def _group_size(args) -> int:
    """The group of a functional op (its name, the last string among its
    arguments) or of a c10d op (the first script object; the reduce op
    comes after it)."""
    names = [a for a in args if isinstance(a, str)]
    if names:
        return _resolve_process_group(names[-1]).size()
    for a in args:
        if isinstance(a, torch.ScriptObject):
            return dist.ProcessGroup.unbox(a).size()
    raise ValueError(f"no process group among {args}")


class CollectiveLog(TorchDispatchMode):
    """Enter to record: ``counts``, ``input_bytes`` and ``sent`` by kind;
    with ``sites=True`` also the model's call site of each (kind, site,
    input bytes), for a mismatch's report."""

    def __init__(self, sites: bool = False):
        super().__init__()
        self.counts: Dict[str, int] = collections.Counter()
        self.input_bytes: Dict[str, int] = collections.Counter()
        self.sent: Dict[str, int] = collections.Counter()
        self.sites = collections.Counter() if sites else None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        entry = _OPS.get(func._overloadpacket.__name__)
        if entry is not None:
            kind, at = entry
            x = args[at]
            nbytes = sum(t.numel() * t.element_size() for t in (x if isinstance(x, list) else [x]))
            self.counts[kind] += 1
            self.input_bytes[kind] += nbytes
            self.sent[kind] += sent_bytes(kind, nbytes, _group_size(args))
            if self.sites is not None:
                frames = [f for f in traceback.extract_stack() if "repro_torch" in f.filename
                          and not f.filename.endswith(("comm.py", "staged.py"))]
                site = f"{Path(frames[-1].filename).name}:{frames[-1].lineno}" if frames else "?"
                self.sites[(kind, site, nbytes)] += 1
        return func(*args, **(kwargs or {}))

    def report(self) -> str:
        return "\n".join(f"  {n} x {k} at {site}, {b} bytes"
                         for (k, site, b), n in sorted((self.sites or {}).items()))


def design_collectives(cfg, sizes: Dict[str, int], micro_rows: int, seq: int) -> dict:
    """The collectives of one micro-step (forward, the remat forward,
    backward, and every gradient onto its parameter's layout) of the
    sharded train step on a ``(data, model)`` or ``(pod, data, model)``
    mesh of ``sizes``, for ``micro_rows`` global rows of ``seq`` tokens,
    from the spec tables:

    * all-gather over ``data`` (FSDP): each layer leaf whose spec shards
      a dim over ``data``, before its block and again in the block's
      recomputation under the ``full`` / ``dots`` policies; each such
      top-level leaf once per use (the tied embedding: the lookup and
      the head); a rank's input is its shard;
    * reduce-scatter over ``data``: each gathered use's gradient back to
      the shard; a rank's input is the gradient of what it gathered
      (its ``model`` shard, the vocab rows for the lookup);
    * all-reduce over ``model``, of a rank's [rows/(pod data), seq, d]
      activations in the compute dtype: per layer the attention and MLP
      outputs (row-parallel; and in the recomputation) and their
      inputs' gradients (column-parallel); the lookup's pending sum over
      the vocab rows (float32); the cross-entropy's max, sum of
      exponentials and label logit over the vocab ([rows/(pod data) x
      seq] float32, in its forward and its recomputation); its input's
      gradient; over ``data``: the loss and its token count (one
      reduction), and each replicated leaf's gradient (float32);
    * the ``pod`` term, on a ``(pod, data, model)`` mesh, where the batch
      is split over both data axes and the parameters are whole over
      ``pod``: after each reduce-scatter its shard's all-reduce over
      ``pod``, and the loss and each replicated leaf's gradient reduced
      over ``pod`` too (each such reduction one all-reduce a mesh dim)."""
    from ..models import registry
    from ..models.common import iter_leaves

    if set(sizes) not in ({"data", "model"}, {"pod", "data", "model"}):
        raise ValueError(f"the design is for a (data, model) or (pod, data, model) mesh, not {sizes}")
    abstract = registry.params_abstract(cfg)
    infos = dict(iter_leaves(abstract))
    specs = dict(iter_leaves(param_pspecs(abstract, sizes)))

    def on(spec, axis):
        return any(a == axis or (isinstance(a, tuple) and axis in a) for a in spec)

    gp, gd, gm = sizes.get("pod", 1), sizes["data"], sizes["model"]
    remat = 1 if cfg.remat_policy in ("full", "dots") else 0
    n_layers = cfg.num_layers
    layer = [n for n in specs if n.startswith("layers.") and on(specs[n], "data")]
    top = [n for n in specs if not n.startswith("layers.") and on(specs[n], "data")]
    uses = {n: 2 if (n == "embed" and cfg.tie_embeddings) else 1 for n in top}
    shard = {n: math.prod(infos[n].shape) * 4 // math.prod(
        s for a, s in sizes.items() if on(specs[n], a)) for n in specs}
    replicated = [n for n in specs if specs[n] == ()]
    gathered = n_layers * sum(shard[n] // n_layers for n in layer)
    tokens = micro_rows // (gp * gd) * seq
    act = tokens * cfg.d_model
    cb = torch.finfo(getattr(torch, cfg.compute_dtype)).bits // 8
    # (input bytes, group size) of each all-reduce
    reduces = ([(act * cb, gm)] * (n_layers * (4 + 2 * remat)) + [(act * 4, gm)]
               + [(tokens * 4, gm)] * 6 + [(act * cb, gm)] + [(8, gd)]
               + [(math.prod(infos[n].shape) * 4, gd) for n in replicated])
    if gp > 1:
        reduces += ([(shard[n] // n_layers, gp) for n in layer for _ in range(n_layers)]
                    + [(shard[n], gp) for n in top for _ in range(uses[n])] + [(8, gp)]
                    + [(math.prod(infos[n].shape) * 4, gp) for n in replicated])
    return {
        "counts": {"all_gather": n_layers * len(layer) * (1 + remat) + sum(uses.values()),
                   "reduce_scatter": n_layers * len(layer) + sum(uses.values()),
                   "all_reduce": len(reduces)},
        "sent": {"all_gather": (gd - 1) * (gathered * (1 + remat)
                                           + sum(shard[n] * uses[n] for n in top)),
                 "reduce_scatter": (gd - 1) * (gathered + sum(shard[n] * uses[n] for n in top)),
                 "all_reduce": sum(sent_bytes("all_reduce", b, g) for b, g in reduces)},
        "layer_leaves": len(layer), "replicated": replicated,
    }
