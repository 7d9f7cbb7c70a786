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
the reference's fields.  This module reads numpy only.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .core.protocol import CONST_FIELDS, INDEX_FIELDS, DevicePlan, device_plan_from_arrays
from .runtime.pool import FaultSpec, WorkerTrace

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
