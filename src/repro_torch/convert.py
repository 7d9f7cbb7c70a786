"""Carry a plan's constants from the JAX package into the port.

The plan constants — share Vandermondes, the Phase-2 mixing matrix, the
blinding Vandermonde, the decode matrix and the block index maps — are
this system's weights: given the same constants, both packages compute
the same Y.  ``device_plan_from_reference`` takes them as a dict of
numpy arrays (the fields of ``repro.core.protocol.DevicePlan``,
converted with ``np.asarray``, optionally with ``"plan.mix"`` and
``"plan.decode_w"``, the plan's own host matrices) and uploads them as
the port's ``DevicePlan``.  It reads numpy only.
"""
from __future__ import annotations

import numpy as np

from .core.protocol import CONST_FIELDS, INDEX_FIELDS, DevicePlan, device_plan_from_arrays

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
