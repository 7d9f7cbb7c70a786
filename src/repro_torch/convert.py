"""Carry a plan's constants and a worker trace from the JAX package into
the port.

The plan constants — share Vandermondes, the Phase-2 mixing matrix, the
blinding Vandermonde, the decode matrix and the block index maps — are
this system's weights: given the same constants, both packages compute
the same Y.  ``device_plan_from_reference`` takes them as a dict of
numpy arrays (the fields of ``repro.core.protocol.DevicePlan``,
converted with ``np.asarray``, optionally with ``"plan.mix"`` and
``"plan.decode_w"``, the plan's own host matrices) and uploads them as
the port's ``DevicePlan``.

A ``WorkerTrace`` is the edge runtime's input: given the same trace,
both packages' schedulers produce the same timelines, subsets and
metrics.  ``worker_trace_from_reference`` builds the port's trace from
the reference's fields.

A model's weights and caches carry across by name, for every family (a
decoder's, an encoder-decoder's ``enc_layers``, ``enc_norm`` and
``dec_layers`` with their cross-attention, xLSTM's ``slstm`` and
``[G, k-1]``-stacked ``mlstm``, Zamba2's ``mamba``, ``shared`` and
``lora``):
``decoder_params_from_reference`` turns the reference's parameter tree
(numpy arrays) into a state dict for the port's ``Model``
(``model.load_state_dict``), and ``decoder_cache_from_reference`` its
cache tree into the port's.  A training state carries across too:
``opt_state_from_reference`` turns the reference's ``AdamWState`` (its
``_asdict()`` as numpy trees) into the port's float32 moments, and
``train_state_to_reference`` takes the port's parameters and optimizer
state back to flat numpy arrays under the reference's ``/`` paths
(``params/layers/attn/wq``, ``opt/step``, ``opt/mu/embed`` ...), the
keys of both packages' checkpoints.  This module reads numpy only.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .checkpoint.manager import flatten
from .core.protocol import CONST_FIELDS, INDEX_FIELDS, DevicePlan, device_plan_from_arrays
from .models import registry
from .models.common import iter_leaves, map_tree
from .runtime.pool import FaultSpec, WorkerTrace
from .train.optimizer import AdamWState

FIELDS = CONST_FIELDS + INDEX_FIELDS


def device_plan_from_reference(arrays: dict, p: int, device="cpu") -> DevicePlan:
    """The port's DevicePlan on ``device`` from the reference's constants.

    Checks that every field is present, that the field elements lie in
    [0, p), and — when the plan's host matrices are given — that
    ``mix_t`` is ``plan.mix.T mod p`` and ``decode_w`` is
    ``plan.decode_w mod p``.  Raises ``ValueError`` otherwise.
    """
    missing = [k for k in FIELDS if k not in arrays]
    if missing:
        raise ValueError(f"reference plan constants lack {missing}")
    host = {k: np.asarray(arrays[k], np.int64) for k in FIELDS}
    for k in CONST_FIELDS:
        if host[k].size and (host[k].min() < 0 or host[k].max() >= p):
            raise ValueError(f"{k} holds values outside [0, {p})")
    checks = (("plan.mix", "mix_t", lambda m: m.T), ("plan.decode_w", "decode_w", lambda m: m))
    for src, dst, view in checks:
        if src in arrays:
            want = view(np.asarray(arrays[src], np.int64)) % p
            if not np.array_equal(want, host[dst]):
                raise ValueError(f"{dst} disagrees with {src}")
    return device_plan_from_arrays(host, device)


def device_plan_to_arrays(dp: DevicePlan) -> dict:
    """The DevicePlan's fields back as host numpy arrays (int64)."""
    return {k: getattr(dp, k).cpu().numpy().astype(np.int64) for k in FIELDS}


def worker_trace_from_reference(fields: dict) -> WorkerTrace:
    """The port's WorkerTrace from the fields of a reference
    ``repro.runtime.pool.WorkerTrace`` (``{f.name: getattr(trace, f.name)}``):
    the per-worker vectors as numpy arrays, ``link_delay`` as a matrix
    or None, ``link_schedule`` as (start, matrix) pairs or None, and
    ``fault_model`` as None, a dict of ``FaultSpec`` fields, or any
    object carrying them.  Raises ``ValueError`` on a missing or unknown
    field."""
    names = [f.name for f in dataclasses.fields(WorkerTrace)]
    unknown = sorted(set(fields) - set(names))
    if unknown:
        raise ValueError(f"unknown WorkerTrace fields {unknown}")
    optional = ("link_delay", "link_schedule", "fault_model")
    missing = [k for k in names if k not in fields and k not in optional]
    if missing:
        raise ValueError(f"reference trace lacks {missing}")
    vectors = {
        k: np.array(fields[k], bool if k in ("dropout", "crash_after_phase2", "corrupt")
                    else np.float64)
        for k in names if k not in optional
    }
    link = fields.get("link_delay")
    schedule = fields.get("link_schedule")
    fm = fields.get("fault_model")
    if fm is not None and not isinstance(fm, dict):
        fm = {f.name: getattr(fm, f.name) for f in dataclasses.fields(FaultSpec)}
    return WorkerTrace(
        **vectors,
        link_delay=None if link is None else np.array(link, np.float64),
        link_schedule=None if schedule is None else tuple(
            (float(t), np.array(m, np.float64)) for t, m in schedule
        ),
        fault_model=None if fm is None else FaultSpec(**fm),
    )


def _check_names(what: str, got: dict, want: dict) -> None:
    if set(got) != set(want):
        raise ValueError(
            f"{what}: missing {sorted(set(want) - set(got))}, "
            f"unknown {sorted(set(got) - set(want))}"
        )
    for name, spec in want.items():
        if tuple(got[name].shape) != tuple(spec.shape):
            raise ValueError(f"{what}: {name} has shape {tuple(got[name].shape)}, want {spec.shape}")


def decoder_params_from_reference(cfg, params: dict) -> dict:
    """A state dict for the port's ``Model`` of ``cfg`` from the
    reference's parameter tree (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``; an MoE model's ``moe`` and
    ``dense_layer_{i}`` subtrees, MLA's ``attn.w_dkv`` / ``w_uk`` /
    ``w_uv``, and an encoder-decoder's ``enc_layers``, ``enc_norm`` and
    ``dec_layers.{self_attn,cross_attn,ln_*,mlp}`` included): dotted
    names, float32 CPU tensors; ``load_state_dict`` casts each into the
    dtype the model keeps it in.  Raises ``ValueError`` on a missing,
    unknown or misshapen weight."""
    got = {name: np.array(x, np.float32) for name, x in iter_leaves(params)}
    _check_names("reference parameters", got, dict(iter_leaves(registry.params_abstract(cfg))))
    return {name: torch.from_numpy(x) for name, x in got.items()}


def _cache_lead(cfg):
    """The stacked cache leaf that gives batch (axis 1) and length (axis 2)."""
    if cfg.family == "ssm":
        return "slstm", "c"  # [G, B, d_in]: no length
    if cfg.family == "hybrid":
        return "shared", "k"
    return "layers", "c" if cfg.mla else "k"


def decoder_cache_from_reference(cfg, caches: dict) -> dict:
    """The port's cache tree on the CPU from the reference's (numpy
    arrays: bfloat16 K/V or MLA ``c`` / ``k_rope`` buffers as float32 or
    as ml_dtypes bfloat16, int32 write positions; the stacked ``layers``
    and any ``dense_{i}`` of a dense prologue; an encoder-decoder's
    ``enc_out`` buffer and ``enc_len``; xLSTM's float32 ``slstm`` ``c`` /
    ``n`` / ``h`` / ``m`` and ``mlstm`` ``c`` / ``n`` / ``m``; Zamba2's
    ``shared`` K/V/``idx`` stacked per invocation and ``mamba`` ``state``
    / ``conv``), each leaf in the port's cache dtype, but a Mamba2
    ``state`` or ``conv`` given in float32 stays float32: the reference's
    prefill and steps leave those in the compute dtype.  Batch and length
    come from the stacked ``k`` (``c`` under MLA, ``shared.k`` for
    Zamba2, ``slstm.c`` for xLSTM, which has no length).  Raises
    ``ValueError`` on a missing, unknown or misshapen leaf."""
    group, lead = _cache_lead(cfg)
    stack = caches.get(group)
    if not isinstance(stack, dict) or lead not in stack or np.ndim(stack[lead]) < 3:
        raise ValueError(f"reference caches: no stacked {group}.{lead} [layers, batch, ...]")
    shape = np.shape(stack[lead])
    length = 0 if cfg.family == "ssm" else shape[2]
    spec = dict(iter_leaves(registry.cache_abstract(cfg, shape[1], length)))
    got = dict(iter_leaves(caches))
    _check_names("reference caches", got, spec)
    out: dict = {}
    for name, x in got.items():
        dtype = spec[name].dtype
        if name.startswith("mamba.") and np.asarray(x).dtype == np.float32:
            dtype = torch.float32
        host = np.array(x, np.float32 if dtype.is_floating_point else np.int64)
        node = out
        *parents, leaf = name.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = torch.from_numpy(host).to(dtype)
    return out


def opt_state_from_reference(cfg, opt: dict, device="cpu") -> AdamWState:
    """The port's ``AdamWState`` on ``device`` from the reference's
    (``state._asdict()`` with numpy leaves: ``step``, and ``mu`` / ``nu``
    trees shaped as ``cfg``'s parameters): an int32 step and float32
    moments.  Raises ``ValueError`` on a missing, unknown or misshapen
    moment."""
    want = dict(iter_leaves(registry.params_abstract(cfg)))
    moments = {}
    for key in ("mu", "nu"):
        got = dict(iter_leaves(opt[key]))
        _check_names(f"reference optimizer {key}", got, want)
        moments[key] = map_tree(
            lambda _, x: torch.from_numpy(np.array(x, np.float32)).to(device), opt[key])
    step = torch.tensor(int(np.asarray(opt["step"])), dtype=torch.int32, device=device)
    return AdamWState(step=step, **moments)


def train_state_to_reference(params: dict, opt: AdamWState) -> dict:
    """``{"params/...": array, "opt/step": array, "opt/mu/...": array,
    "opt/nu/...": array}``: the port's parameters and optimizer state as
    host numpy arrays under the reference's ``/`` paths.  A sharded tree
    (DTensor leaves) is gathered to its full values first, so every rank
    of its mesh calls this."""
    return flatten({"params": params, "opt": opt._asdict()})
