"""Berlekamp-Welch error-correcting decode over GF(p).

The Phase-3 responses are evaluations of the degree-``thr - 1``
polynomial I(x) at distinct points — a Reed-Solomon codeword — so a
Byzantine worker that responds with garbage is a *symbol error*, not a
protocol failure.  Given ``k >= thr + 2e`` evaluations of which at most
``e`` are corrupted, Berlekamp-Welch recovers I(x) exactly and names
the corrupted evaluation points (the Maddah-Ali adversarial-MPC line,
arXiv:2004.04985 / 1908.04255, applied to the CMPC decode).

The key system: find a monic *error locator* ``E(x)`` of degree ``e``
and ``Q(x)`` of degree ``< thr + e`` with

    Q(x_i) = y_i * E(x_i)        for every received evaluation i.

Writing ``E(x) = x^e + sum_{j<e} lam_j x^j`` this is linear in the
``thr + 2e`` unknowns ``(q, lam)``.  With at most ``e`` errors the
system is consistent (take E = the true locator padded with roots at 0
and Q = I*E) and *every* solution satisfies ``Q = I * E`` exactly (the
classic argument: two solutions' cross-difference ``Q1*E2 - Q2*E1`` has
degree ``< thr + 2e`` but vanishes at ``k >= thr + 2e`` points), so one
particular solution of the possibly-singular system suffices —
``Field.solve_any`` pins free variables to zero.  The corrupted rows
are exactly where the recovered I(x) mismatches the evaluation.

Vector payloads (each worker returns a whole block of I(alpha_n), and
the batched runtime folds the batch in as well) share one error
pattern: a corrupt worker is corrupt for every payload column.  So the
locator is found ONCE on a random GF(p) linear combination of the
columns — a corrupt row survives the combination unless its garbage
happens to dot to the true value (probability 1/p per trial) — and the
full payload is then decoded from ``thr`` clean rows and verified
against every other clean row.  A fluked combination fails that
verification and retries with a fresh combination vector.

A copy of the JAX package's ``repro.core.bw_decode`` (plain Python and numpy),
kept here so that the port imports nothing of that package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..obs.metrics import REGISTRY
from ..obs.tracer import TRACER
from .gf import Field


class BWDecodeError(ValueError):
    """No consistent Berlekamp-Welch decode within the error budget."""


def bw_system_size(thr: int, e: int) -> int:
    """Responses needed to correct ``e`` errors: ``thr + 2e``."""
    return int(thr) + 2 * int(e)


def _bw_locate(
    field: Field, xs: np.ndarray, v: np.ndarray, u: np.ndarray, thr: int, e: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Scalar Berlekamp-Welch: recover the combined polynomial and the
    error rows from one codeword ``u`` of evaluations at ``xs``.

    ``v`` is the Vandermonde of ``xs`` on powers ``0..thr+e-1`` (the
    ``Q`` block; its first ``e`` columns double as the low-order ``E``
    block and column ``e`` as the monic term).  Returns
    ``(coeffs [thr], err_rows)`` or raises :class:`BWDecodeError` when
    more than ``e`` rows are corrupted.
    """
    p = field.p
    u = field.asarray(u)
    if e == 0:
        a = v[:, :thr]
        rhs = u
    else:
        lam_block = (-(u[:, None] * v[:, :e])) % p
        a = np.concatenate([v[:, : thr + e], lam_block], axis=1)
        rhs = (u * v[:, e]) % p
    try:
        x = field.solve_any(a, rhs)
    except ValueError as exc:
        raise BWDecodeError(
            f"no Berlekamp-Welch solution within error budget e={e} "
            f"({u.size} evaluations, threshold {thr})"
        ) from exc
    if e == 0:
        coeffs = x
    else:
        q, lam = x[: thr + e], x[thr + e :]
        locator = np.concatenate([lam, np.ones(1, np.int64)])  # monic deg e
        quo, rem = field.poly_divmod(q, locator)
        if np.any(rem != 0):
            raise BWDecodeError(
                f"error locator does not divide Q(x): more than e={e} "
                f"corrupted evaluations among {u.size}"
            )
        coeffs = np.zeros(thr, np.int64)
        coeffs[: min(quo.size, thr)] = quo[:thr]
    err = np.flatnonzero(field.poly_eval(coeffs, xs) != u)
    if err.size > e:
        raise BWDecodeError(
            f"{err.size} mismatching evaluations exceed error budget e={e}"
        )
    return coeffs, err


def _combine(
    field: Field, ys: np.ndarray, rng: np.random.Generator
) -> np.ndarray:
    """Random GF(p) linear combination of the payload columns."""
    if ys.shape[1] == 1:
        return ys[:, 0]
    r = field.random(rng, ys.shape[1])
    return field.matmul(ys, r[:, None])[:, 0]


def bw_interpolate(
    field: Field,
    xs: np.ndarray,
    ys: np.ndarray,
    thr: int,
    e: int,
    rng: Optional[np.random.Generator] = None,
    max_combine_tries: int = 4,
) -> Tuple[np.ndarray, np.ndarray]:
    """Error-correcting interpolation from ``k >= thr + 2e`` evaluations.

    ``xs``: [k] distinct evaluation points; ``ys``: [k] or [k, payload]
    evaluations of a degree-``< thr`` polynomial (vector payloads share
    one error pattern — whole rows are corrupt or clean).  Returns
    ``(coeffs [thr, payload], err_rows)`` with ``err_rows`` the sorted
    row indices identified (and corrected) as corrupt.  Raises
    :class:`BWDecodeError` when more than ``e`` rows are corrupted.
    """
    xs = field.asarray(np.atleast_1d(xs))
    ys = field.asarray(ys)
    squeeze = ys.ndim == 1
    if squeeze:
        ys = ys[:, None]
    k = int(xs.size)
    if ys.shape[0] != k:
        raise ValueError(f"{k} points but {ys.shape[0]} evaluation rows")
    if e < 0:
        raise ValueError("error budget e must be >= 0")
    if k < bw_system_size(thr, e):
        raise ValueError(
            f"need >= thr + 2e = {bw_system_size(thr, e)} evaluations to "
            f"correct e={e} errors, got {k}"
        )
    if np.unique(xs).size != k:
        raise ValueError("evaluation points must be distinct")
    rng = rng or np.random.default_rng(0)
    v = field.vandermonde(xs, range(thr + e))
    for _ in range(max_combine_tries):
        u = _combine(field, ys, rng)
        coeffs_u, err = _bw_locate(field, xs, v, u, thr, e)
        del coeffs_u  # the locator is what matters; decode the payload below
        clean = np.setdiff1d(np.arange(k), err)
        sub = clean[:thr]
        coeffs = field.solve(v[sub][:, :thr], ys[sub])
        pred = field.matmul(v[clean][:, :thr], coeffs)
        if np.array_equal(pred, ys[clean]):
            err = _tighten_errors(field, v[:, :thr], ys, coeffs, err)
            return (coeffs[:, 0] if squeeze else coeffs), err
        # The combination dotted a corrupt row to its true value (prob
        # 1/p per row per trial) and the row slipped into the clean set:
        # redraw and relocate.
    raise BWDecodeError(
        f"payload verification failed {max_combine_tries} times — "
        f"more than e={e} corrupted rows"
    )


def _tighten_errors(
    field: Field,
    v_thr: np.ndarray,
    ys: np.ndarray,
    coeffs: np.ndarray,
    err: np.ndarray,
) -> np.ndarray:
    """Keep only flagged rows that actually mismatch the full payload
    (a spurious locator root at a clean point flags nothing real)."""
    if not err.size:
        return err
    pred = field.matmul(v_thr[err], coeffs)
    return err[np.any(pred != ys[err], axis=1)]


def bw_decode_evals(
    plan,
    i_evals: np.ndarray,
    worker_ids: np.ndarray,
    e: int,
    rng: Optional[np.random.Generator] = None,
    max_combine_tries: int = 4,
) -> Tuple[np.ndarray, np.ndarray]:
    """Plan-aware Berlekamp-Welch decode of Phase-3 responses.

    ``i_evals``: [n_total, payload] worker-stacked I(alpha_n) rows (only
    the ``worker_ids`` rows are read); ``worker_ids``: the responder
    subset, ``>= thr + 2e`` of them, in arrival (fastest-first) order so
    the final clean interpolation uses the fastest clean responders.
    Returns ``(coeffs [thr, payload], corrected_ids)`` where
    ``corrected_ids`` are the worker ids identified as corrupt (sorted).
    Raises :class:`BWDecodeError` when more than ``e`` rows are corrupt.

    Subset matrices route through the plan's caches
    (:meth:`~repro_torch.core.planner.CMPCPlan.bw_decode_matrices` for the
    locator system, ``decode_matrix_cached`` for the clean
    interpolation, ``decode_check_matrix`` for verification), so a
    recurring fastest subset pays one Gauss-Jordan total.
    """
    field = plan.field
    thr = plan.decode_threshold
    ids = np.asarray(worker_ids)
    k = int(ids.size)
    if k < bw_system_size(thr, e):
        raise ValueError(
            f"need >= thr + 2e = {bw_system_size(thr, e)} responders to "
            f"correct e={e} errors, got {k}"
        )
    flat = field.asarray(i_evals).reshape(i_evals.shape[0], -1)
    xs = plan.alphas[ids]
    v = plan.bw_decode_matrices(ids, e)  # [k, thr+e] cached Vandermonde
    check = plan.decode_check_matrix()  # [n_total, thr]
    rng = rng or np.random.default_rng(0)
    ys = flat[ids]
    for attempt in range(max_combine_tries):
        REGISTRY.counter("bw.combine_attempts").inc()
        u = _combine(field, ys, rng)
        _, err = _bw_locate(field, xs, v, u, thr, e)
        clean_ids = ids[np.setdiff1d(np.arange(k), err)]
        sub = np.sort(clean_ids[:thr])  # canonical key for the plan cache
        w_dec = plan.decode_matrix_cached(sub)
        coeffs = field.matmul(w_dec, flat[sub])
        pred = field.matmul(check[clean_ids], coeffs)
        ok = np.array_equal(pred, flat[clean_ids])
        if TRACER.enabled:
            TRACER.event(
                "bw_decode.combine", attempt=attempt, e=int(e),
                n_responders=k, n_flagged=int(err.size), ok=bool(ok),
            )
        if ok:
            bad = ids[err]
            if bad.size:
                pred_bad = field.matmul(check[bad], coeffs)
                bad = bad[np.any(pred_bad != flat[bad], axis=1)]
            return coeffs, np.sort(bad)
    REGISTRY.counter("bw.combine_exhausted").inc()
    raise BWDecodeError(
        f"payload verification failed {max_combine_tries} times — "
        f"more than e={e} corrupted responders among {k}"
    )
