"""Multi-pod dry-run: the torch form of ``repro.launch.dryrun``.

For every (architecture x applicable shape x mesh) cell this builds the
real step (``launch.steps.build_step``: the train step, the prefill or
the decode step) on the production mesh over a *fake* process group --
rank 0 of 256 (16 x 16) or 512 (2 x 16 x 16) ranks, whose collectives
return at once -- and traces rank 0's step on fake tensors
(``FakeTensorMode``), so nothing is allocated.  It records:

* ``memory``: the bytes of the step's arguments a rank holds (its
  shards of the parameters, the AdamW moments and step, the batch and
  the caches; ``argument_size_in_bytes``, the reference's field) and the
  peak of the live bytes during the step (``peak_live_bytes``: the
  storages the step's ops make, freed as they die, over the arguments);
* ``cost.flops``: the FLOPs of rank 0's products (the ops
  ``torch.utils.flop_counter`` counts), on its *local* shards: an op on
  DTensors counts the global op's FLOPs times its output's local share,
  divided by the mesh dims its contraction is split over (a pending
  sum), and an op on a rank's own tensors counts as it is;
* ``collective_bytes`` and ``collective_counts`` by kind, through
  ``distributed.comm.CollectiveLog`` (the bytes a rank sends,
  ring-wise; ``collective_input_bytes`` the collectives' inputs);
* ``n_devices``, ``params``, ``active_params``, ``cache_bytes`` and
  ``trace_s`` (in place of the reference's ``lower_s`` / ``compile_s``).

A train step traces one micro-step (its forward and backward) and
multiplies it by the step's ``n_micro``, as the reference's HLO walker
multiplies a ``scan`` body by its trip count (``micro_steps_traced``:
1), then adds the gradients' placement and the AdamW update once; the
record's ``micro_step`` holds one micro-step with its gradients placed,
the unit ``comm.design_collectives`` predicts.  ``run_cell(...,
layers=(l1, l2))`` goes one step further for a deep model: it traces the
step at two depths and extrapolates to the full stack (``extrapolated``;
``layers_traced`` in the record), the CLI traces every layer.

There is no program text: ``--save-hlo`` is refused, and the reference's
``hlo_cost`` and ``rewalk`` walkers, which exist because XLA's
``cost_analysis`` counts a loop body once, have no counterpart (the
trace runs every layer).

Usage (the reference's CLI; one JSON per cell under ``--out``, cells
whose JSON exists skipped unless ``--force``; non-zero exit if a cell
failed):

    python -m repro_torch.launch.dryrun --arch all --shape all --mesh both \\
        --out results/dryrun_torch
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..configs import SHAPES, get_config, registry as cfg_registry, shape_applicable
from ..distributed.sharding import wrap_local
from ..models.common import iter_leaves, map_tree

NO_HLO = ("--save-hlo: a torch step is traced, not compiled; there is no optimized HLO to "
          "save (the record holds what the reference reads from it)")


def cells(arch_sel: str, shape_sel: str, mesh_sel: str):
    archs = cfg_registry.ARCH_NAMES if arch_sel == "all" else tuple(arch_sel.split(","))
    shapes = tuple(SHAPES) if shape_sel == "all" else tuple(shape_sel.split(","))
    meshes = ("single", "multi") if mesh_sel == "both" else (mesh_sel,)
    for a in archs:
        for s in shapes:
            for m in meshes:
                yield a, s, m


@contextlib.contextmanager
def fake_world(n: int):
    """A fake default process group of ``n`` ranks, this process rank 0:
    its collectives return at once.  Destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; the dry-run makes its own "
                           "fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------
# what a rank does: FLOPs and live bytes
# ----------------------------------------------------------------------
class LocalFlops(TorchDispatchMode):
    """The FLOPs of the products a rank computes (``flop_registry``'s
    ops).  An op on DTensors reaches this mode as the global op: its
    FLOPs times the local share of its output, divided by the product of
    the mesh dims its output is pending over (its contraction split).
    The ops DTensor runs on the local shards inside do not reach it, and
    an op on plain tensors (a rank's own computation) counts as it is."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = self.registry.get(func._overloadpacket)
        if count is not None:
            n = count(*args, **kwargs, out_val=out)
            if isinstance(out, DTensor):
                mesh = out.device_mesh
                pending = math.prod(mesh.size(i) for i, p in enumerate(out.placements)
                                    if p.is_partial())
                n = n * out._local_tensor.numel() // max(out.numel(), 1) // pending
            self.flops += int(n)
        return out


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages the ops make (a DTensor's local shard),
    each counted once however many views share it and dropped when the
    last of them dies; ``peak`` the most alive at once.  The storages of
    ``held`` (the step's arguments, alive throughout) count from the
    start, once, whatever op writes them in place."""

    def __init__(self, held=()):
        super().__init__()
        self.refs: Dict[int, list] = {}
        for t in held:
            st = _local(t).untyped_storage()
            self.refs.setdefault(st._cdata, [st.nbytes(), 1])
        self.live = self.peak = sum(b for b, _ in self.refs.values())

    def _drop(self, key):
        entry = self.refs[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self.refs[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            t = _local(t)
            key = t.untyped_storage()._cdata
            entry = self.refs.get(key)
            if entry is None:
                entry = self.refs[key] = [t.untyped_storage().nbytes(), 0]
                self.live += entry[0]
                self.peak = max(self.peak, self.live)
            entry[1] += 1
            weakref.finalize(t, self._drop, key)
        return out


# ----------------------------------------------------------------------
# fake arguments
# ----------------------------------------------------------------------
def local_shape(shape, placements, mesh) -> tuple:
    """Rank 0's shard of a tensor of ``shape`` under ``placements``."""
    dims = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            dims[p.dim] = -(-dims[p.dim] // mesh.size(i))
    return tuple(dims)


def _fake_leaf(shape, dtype, placements, mesh, requires_grad=False):
    local = torch.zeros(local_shape(shape, placements, mesh), dtype=dtype)
    out = wrap_local(local, mesh, placements, shape)
    return out.requires_grad_() if requires_grad else out


def _tree(abstract, shardings, mesh, fn):
    flat = dict(iter_leaves(shardings))
    return map_tree(lambda name, s: fn(name, s, flat[name]), abstract)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if isinstance(t, DTensor) else t


def _nbytes(t) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


def fake_args(bundle):
    """The bundle's arguments as fake tensors on its mesh, each rank
    holding its shards: the parameters in the dtype the model keeps them
    in (float32 for training, ``lm.stored_infos``' to serve), the AdamW
    state, and zero batches and caches of the abstract shapes."""
    from ..models import lm
    from ..train.optimizer import adamw_init

    mesh, cfg, train = bundle.mesh, bundle.cfg, bundle.kind == "train"
    infos = bundle.args_abstract[0]
    if not train:
        infos = lm.stored_infos(cfg, infos)
    params = _tree(infos, bundle.in_shardings[0], mesh,
                   lambda _, i, pl: _fake_leaf(i.shape, i.dtype, pl, mesh, train))
    rest = []
    for abstract, sh in zip(bundle.args_abstract[1:], bundle.in_shardings[1:]):
        if hasattr(abstract, "_fields"):  # the optimizer state
            rest.append(adamw_init(params, bundle.opt_cfg))
        elif isinstance(abstract, dict):
            rest.append(_tree(abstract, sh, mesh, lambda _, s, pl: _fake_leaf(s.shape, s.dtype,
                                                                           pl, mesh)))
        else:  # the decode step's tokens and positions: the global values
            rest.append(torch.zeros(abstract.shape, dtype=abstract.dtype))
    return (params,) + tuple(rest)


# ----------------------------------------------------------------------
# the trace
# ----------------------------------------------------------------------
@contextlib.contextmanager
def _counted(held):
    from ..distributed.comm import CollectiveLog

    log, flops, live = CollectiveLog(), LocalFlops(), LiveBytes(held)
    with live, log, flops:
        yield log, flops, live


def _part(log, flops) -> dict:
    return {"flops": flops.flops, "collective_counts": dict(log.counts),
            "collective_bytes": dict(log.sent), "collective_input_bytes": dict(log.input_bytes)}


def _sum(parts, weights) -> dict:
    out = {"flops": sum(w * p["flops"] for p, w in zip(parts, weights))}
    for key in ("collective_counts", "collective_bytes", "collective_input_bytes"):
        kinds = sorted({k for p in parts for k in p[key]})
        out[key] = {k: sum(w * p[key].get(k, 0) for p, w in zip(parts, weights)) for k in kinds}
    return out


def _held(args, train: bool) -> list:
    """What a rank holds of a step's arguments: its shards (a decode
    step's tokens and positions are global values the bundle places) and,
    training, the AdamW step."""
    return [t for t in tree_leaves(args)
            if isinstance(t, DTensor) or (train and isinstance(t, torch.Tensor))]


def argument_bytes(bundle) -> int:
    """The bytes of ``bundle``'s arguments a rank holds (fake tensors, no
    trace)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        return sum(_nbytes(t) for t in _held(fake_args(bundle), bundle.kind == "train"))


def extrapolated(cfg, mesh, shape, layers) -> dict:
    """The record of ``cfg``'s step on ``mesh`` from traces at two depths
    ``layers`` = (l1, l2) of its ``num_layers`` L: every layer of the stack
    runs the same ops, so each count, byte total and FLOP count is
    ``v(l1) + (v(l2) - v(l1)) (L - l1) / (l2 - l1)``, exactly (it raises
    where that is not a whole number; depths that are multiples of a
    model's period, Zamba2's shared-block spacing, keep it exact), as
    the reference's walker multiplies a scanned layer by its trip count.  The
    peak is extrapolated the same way (rounded); the argument bytes are
    the full depth's own."""
    from ..models import registry
    from .steps import build_step

    l1, l2 = layers
    big = cfg.num_layers
    train = shape.kind == "train"
    recs = [build_step(registry.Model(dataclasses.replace(cfg, num_layers=n), {}, train=train),
                       mesh, shape).lower() for n in layers]

    def ext(a, b, exact=True):
        if isinstance(a, dict):
            return {k: ext(a.get(k, 0), b.get(k, 0), exact) for k in sorted(set(a) | set(b))}
        more, rem = divmod((b - a) * (big - l1), l2 - l1)
        if exact and rem:
            raise ValueError(f"{a} at {l1} layers, {b} at {l2}: not linear in the layers")
        return a + more if exact else round(a + (b - a) * (big - l1) / (l2 - l1))

    r1, r2 = recs
    out = dict(r2)
    out.update(
        trace_s=round(r1["trace_s"] + r2["trace_s"], 2), layers_traced=[l1, l2],
        memory={"argument_size_in_bytes": argument_bytes(
                    build_step(registry.Model(cfg, {}, train=train), mesh, shape)),
                "peak_live_bytes": ext(r1["memory"]["peak_live_bytes"],
                                       r2["memory"]["peak_live_bytes"], exact=False)},
        cost={"flops": float(ext(int(r1["cost"]["flops"]), int(r2["cost"]["flops"])))})
    for key in ("collective_bytes", "collective_counts", "collective_input_bytes"):
        out[key] = ext(r1[key], r2[key])
    if "micro_step" in r1:
        out["micro_step"] = ext(r1["micro_step"], r2["micro_step"])
    return out


def trace_bundle(bundle) -> dict:
    """``bundle``'s dry-run record: its step traced for rank 0 on fake
    tensors (under ``FakeTensorMode``; the mesh's process group should be
    a fake one, as ``run_cell`` makes it, so no collective runs)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..train.optimizer import adamw_update
    from . import steps

    train = bundle.kind == "train"
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = fake_args(bundle)
        held = _held(args, train)
        arg_bytes = sum(_nbytes(t) for t in held)
        if not train:
            with _counted(held) as (log, flops, live):
                bundle(*args)
            step, micro, n_micro = _part(log, flops), None, 1
        else:
            params, opt, batch = args
            n_micro = bundle.n_micro
            with _counted(held) as (log, flops, live), \
                    steps.sharded(steps.activation_rules(bundle.mesh)):
                steps.micro_step(bundle.cfg, params, steps.micro_batch(
                    batch, 0, n_micro, bundle.in_shardings[2], bundle.mesh))
                fwd_bwd = _part(log, flops)
                steps.place_grads([p for _, p in iter_leaves(params)], n_micro)
                micro = _part(log, flops)
                adamw_update(map_tree(lambda _, p: p.grad, params), opt, params, bundle.opt_cfg)
                whole = _part(log, flops)
            # the step: n_micro micro-steps, then the placement and the update once
            step = _sum([whole, fwd_bwd], [1, n_micro - 1])
    record = {
        "status": "ok",
        "trace_s": round(time.perf_counter() - t0, 2),
        "n_devices": int(bundle.mesh.size()),
        "memory": {"argument_size_in_bytes": int(arg_bytes), "peak_live_bytes": int(live.peak)},
        "cost": {"flops": float(step["flops"])},
        "collective_bytes": step["collective_bytes"],
        "collective_counts": step["collective_counts"],
        "collective_input_bytes": step["collective_input_bytes"],
        "micro_steps_traced": 1,
        "n_micro": n_micro,
    }
    if micro is not None:
        record["micro_step"] = micro
    return record


def run_cell(arch: str, shape_name: str, mesh_kind: str, verbose: bool = True,
             hlo_path: str = None, *, cfg=None, shape=None, mesh_dims=None, layers=None) -> dict:
    """One cell's record, the reference's fields where one fits.  ``cfg``,
    ``shape`` and ``mesh_dims`` (a (shape, axes) pair) replace the
    arch's config, the named shape and the production mesh (a reduced
    cell on a small fake mesh).  ``layers`` (two depths) extrapolates the
    record from traces at those depths (``extrapolated``) instead of
    tracing every layer."""
    from ..models import registry
    from .mesh import make_mesh
    from .steps import build_step

    if hlo_path:
        raise NotImplementedError(NO_HLO)
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_kind,
        "kind": shape.kind,
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }
    if not shape_applicable(cfg, shape):
        record["status"] = "skipped"
        record["reason"] = (
            "long_500k needs sub-quadratic attention"
            if shape_name == "long_500k"
            else "no decode path"
        )
        return record
    if mesh_dims is None:
        multi = mesh_kind == "multi"
        mesh_dims = (((2, 16, 16), ("pod", "data", "model")) if multi
                     else ((16, 16), ("data", "model")))
    dims, axes = mesh_dims
    if shape.kind != "train":
        cache_abs = registry.cache_abstract(cfg, shape.global_batch, shape.seq_len)
        record["cache_bytes"] = int(sum(math.prod(s.shape) * s.dtype.itemsize
                                        for _, s in iter_leaves(cache_abs)))
    with fake_world(math.prod(dims)):
        mesh = make_mesh(dims, axes, "cpu")
        if layers is None:
            record.update(build_step(registry.Model(cfg, {}, train=shape.kind == "train"), mesh,
                                     shape).lower())
        else:
            record.update(extrapolated(cfg, mesh, shape, layers))
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_kind}] memory: {record['memory']}, flops "
              f"{record['cost']['flops']:.4g}, collectives {record['collective_counts']}, "
              f"traced in {record['trace_s']} s")
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=("single", "multi", "both"))
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--save-hlo", action="store_true",
                    help="refused: a traced torch step has no optimized HLO")
    args = ap.parse_args(argv)
    if args.save_hlo:
        raise SystemExit(NO_HLO)

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch, shape_name, mesh_kind in cells(args.arch, args.shape, args.mesh):
        path = os.path.join(args.out, f"{arch}__{shape_name}__{mesh_kind}.json")
        if os.path.exists(path) and not args.force:
            print(f"skip (exists): {path}")
            continue
        print(f"=== dry-run {arch} x {shape_name} x {mesh_kind} ===", flush=True)
        try:
            rec = run_cell(arch, shape_name, mesh_kind)
        except Exception as e:  # fault-tolerant sweep: record and continue
            rec = {
                "arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "error", "error": repr(e),
                "traceback": traceback.format_exc()[-4000:],
            }
            failures += 1
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"-> {rec.get('status')} ({path})", flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
