"""CMPC execution planning.

A ``CMPCPlan`` freezes everything that is *data independent* about one
protocol instance: the share construction (``Scheme``), the field, the
evaluation points alpha_n, the Phase-2 mixing matrix (Lagrange-style
coefficients r_n^{(i,l)} folded with the receiver Vandermonde), the
Phase-3 decode matrix, and block-shape bookkeeping.  Plans are computed
on the host in exact int64 and shipped to devices as int32 constants.

Worker redundancy: ``n_spare`` extra evaluation points provide
straggler tolerance in Phase 2 — any ``n_workers`` of the
``n_workers + n_spare`` provisioned workers can serve Phase 2 (the
mixing matrix is recomputed per surviving subset via ``phase2_matrix``),
and any ``t^2 + z`` of those can serve Phase 3.

``get_plan`` is the cached entry point: one plan per
``(scheme, shapes, field, n_spare, seed)`` signature, shared
process-wide so repeated layer calls reuse the Vandermonde / mixing
constants instead of re-running Gauss-Jordan inversions
(``plan_cache_info`` / ``plan_cache_clear`` expose the counters).

A copy of the JAX package's ``repro.core.planner`` (plain Python and numpy),
kept here so that the port imports nothing of that package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from ..obs.tracer import TRACER
from .constructions import PlanConfig, Scheme
from .gf import Field


@dataclasses.dataclass(frozen=True)
class BlockShapes:
    """Partition bookkeeping for Y = A^T B.

    A: [k, ma]  (so A^T: [ma, k]), B: [k, mb], Y: [ma, mb].
    A^T is split into t x s blocks of [ma/t, k/s]; B into s x t blocks
    of [k/s, mb/t].
    """

    k: int
    ma: int
    mb: int
    s: int
    t: int

    def __post_init__(self):
        if self.k % self.s:
            raise ValueError(f"s={self.s} must divide inner dim k={self.k}")
        if self.ma % self.t or self.mb % self.t:
            raise ValueError(f"t={self.t} must divide output dims {self.ma}, {self.mb}")

    @property
    def blk_a(self) -> Tuple[int, int]:
        return (self.ma // self.t, self.k // self.s)

    @property
    def blk_b(self) -> Tuple[int, int]:
        return (self.k // self.s, self.mb // self.t)

    @property
    def blk_y(self) -> Tuple[int, int]:
        return (self.ma // self.t, self.mb // self.t)


@dataclasses.dataclass(frozen=True)
class CMPCPlan:
    scheme: Scheme
    field: Field
    shapes: BlockShapes
    n_spare: int
    alphas: np.ndarray  # [n_total] distinct nonzero points
    va: np.ndarray  # [n_total, |P(F_A)|] Vandermonde on F_A support
    vb: np.ndarray  # [n_total, |P(F_B)|]
    # Phase 2: mix[n, n'] = sum_{i,l} r_n^{(i,l)} alpha_{n'}^{i+t*l}
    # for the primary worker set (first n_workers alphas).
    mix: np.ndarray  # [n_workers, n_total]
    vnoise: np.ndarray  # [n_total, z] receiver Vandermonde on powers t^2+w
    decode_w: np.ndarray  # [t^2+z, t^2+z] inverse Vandermonde, first t^2+z workers
    important_idx: np.ndarray  # [t, t] -> index of u_{i,l} in h_powers

    @property
    def n_workers(self) -> int:
        return self.scheme.n_workers

    @property
    def n_total(self) -> int:
        return self.n_workers + self.n_spare

    @property
    def decode_threshold(self) -> int:
        return self.scheme.decode_threshold

    # ------------------------------------------------------------------
    def phase2_matrix(self, worker_ids: Sequence[int]) -> np.ndarray:
        """Recompute the Phase-2 mixing matrix for an arbitrary surviving
        subset of exactly ``n_workers`` workers (straggler mitigation)."""
        return _phase2_matrix(self.scheme, self.field, self.alphas, np.asarray(worker_ids))

    def decode_matrix(self, worker_ids: Sequence[int]) -> np.ndarray:
        """Inverse Vandermonde for Phase-3 reconstruction from any
        ``t^2 + z`` workers."""
        ids = np.asarray(worker_ids)
        if ids.size != self.decode_threshold:
            raise ValueError(
                f"need exactly {self.decode_threshold} workers, got {ids.size}"
            )
        v = self.field.vandermonde(self.alphas[ids], range(self.decode_threshold))
        return self.field.inv_matrix(v)

    # ------------------------------------------------------------------
    # per-subset matrix caches (straggler-aware runtime hot path)
    # ------------------------------------------------------------------
    # The edge runtime decodes from whatever responder subset happens to
    # be fastest, and under a stationary latency distribution the same
    # few subsets recur run after run.  Both subset matrices cost a
    # Gauss-Jordan inversion mod p in Python, so they get the same
    # treatment as ``get_plan``: a bounded insertion-ordered cache, here
    # per plan (keyed by the frozen id tuple) since the matrices are
    # meaningless across plans.  The primary prefix bypasses the cache
    # entirely — it is already stored on the plan.

    def phase2_matrix_cached(self, worker_ids: Sequence[int]) -> np.ndarray:
        ids = np.asarray(worker_ids)
        if ids.size == self.n_workers and np.array_equal(ids, np.arange(self.n_workers)):
            return self.mix
        return self._subset_cached("mix", ids, self.phase2_matrix)

    def decode_check_matrix(self) -> np.ndarray:
        """Vandermonde of *every* provisioned alpha on the decode powers
        0..t^2+z-1 — the master's consistency-check matrix (an accepted
        I(x) must reproduce the evaluations of extra responders).  Built
        once per plan and memoized like ``device_plan``: the edge
        runtime consults it on every run, and rebuilding it was a
        per-call host loop in the replay hot path."""
        v = self.__dict__.get("_decode_check_v")
        if v is None:
            _DECODE_CHECK_STATS["misses"] += 1
            v = self.field.vandermonde(self.alphas, range(self.decode_threshold))
            object.__setattr__(self, "_decode_check_v", v)
        else:
            _DECODE_CHECK_STATS["hits"] += 1
        return v

    def decode_matrix_cached(self, worker_ids: Sequence[int]) -> np.ndarray:
        ids = np.asarray(worker_ids)
        thr = self.decode_threshold
        if ids.size == thr and np.array_equal(ids, np.arange(thr)):
            return self.decode_w
        return self._subset_cached("dec", ids, self.decode_matrix)

    def bw_decode_matrices(self, worker_ids: Sequence[int], e: int) -> np.ndarray:
        """Vandermonde block behind the Berlekamp-Welch key system for a
        responder subset: ``V[i, j] = alphas[ids[i]] ** j`` on powers
        ``0..thr+e-1``.  Columns ``0..thr+e-1`` are the Q(x) block, its
        first ``e`` columns double as the low-order error-locator block,
        and column ``e`` carries the monic ``x^e`` term — one matrix
        serves the whole system.  Rows follow the given (arrival) order;
        cached per ``(subset order, e)`` alongside the decode/check
        caches, so the recurring fastest ``thr + 2e`` responders pay one
        power-table build total.
        """
        ids = np.asarray(worker_ids)
        e = int(e)
        if e < 0:
            raise ValueError("error budget e must be >= 0")
        width = self.decode_threshold + e

        def build(ids_arr: np.ndarray) -> np.ndarray:
            return self.field.vandermonde(self.alphas[ids_arr], range(width))

        return self._subset_cached(f"bw{e}", ids, build)

    def _subset_cached(self, kind: str, ids: np.ndarray, build) -> np.ndarray:
        cache = self.__dict__.get("_subset_cache")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_subset_cache", cache)
        key = (kind, tuple(int(i) for i in ids))
        hit = cache.get(key)
        if hit is not None:
            _SUBSET_CACHE_STATS["hits"] += 1
            return hit
        _SUBSET_CACHE_STATS["misses"] += 1
        mat = build(ids)
        cache[key] = mat
        while len(cache) > _SUBSET_CACHE_MAX:
            cache.pop(next(iter(cache)))
        return mat


def _phase2_rows(
    scheme: Scheme, field: Field, alphas: np.ndarray, ids: np.ndarray
) -> np.ndarray:
    """r[(i,l), n]: interpolation rows extracting the important
    coefficients u_{i,l} from the sender subset ``ids`` — the expensive
    (Gauss-Jordan) sender-side half of the Phase-2 mixing matrix,
    independent of the receiver set."""
    if ids.size != scheme.n_workers:
        raise ValueError(
            f"phase 2 needs exactly {scheme.n_workers} workers, got {ids.size}"
        )
    t = scheme.t
    h_powers = list(scheme.h_powers)
    v_h = field.vandermonde(alphas[ids], h_powers)  # [N, |P(H)|]
    v_inv = field.inv_matrix(v_h)  # coeff = v_inv @ evals
    imp_map = scheme.coded.important_map()
    pos = {u: j for j, u in enumerate(h_powers)}
    r = np.zeros((t * t, ids.size), np.int64)
    for (i, l), u in imp_map.items():
        r[i + t * l] = v_inv[pos[u]]
    return r


def _mix_from_rows(
    scheme: Scheme, field: Field, r: np.ndarray, alphas: np.ndarray
) -> np.ndarray:
    """Fold sender rows with the receiver Vandermonde (cheap half)."""
    # receiver Vandermonde on G powers {i + t*l} = 0..t^2-1
    v_g = field.vandermonde(alphas, range(scheme.t * scheme.t))
    # mix[n, n'] = sum_g r[g, n] * v_g[n', g]
    return field.matmul(r.T, v_g.T)  # [N, n_receivers]


def _phase2_matrix(
    scheme: Scheme, field: Field, alphas: np.ndarray, ids: np.ndarray
) -> np.ndarray:
    """mix[n, n'] for senders ``ids`` (interpolating H's support from the
    evaluations at alphas[ids]) and all receivers."""
    r = _phase2_rows(scheme, field, alphas, ids)
    return _mix_from_rows(scheme, field, r, alphas)


# ----------------------------------------------------------------------
# plan cache
# ----------------------------------------------------------------------
# Plans are pure functions of (scheme, shapes, field, n_spare, seed) but
# cost Vandermonde inversions (Gauss-Jordan mod p in Python) to build.
# Layer code calls get_plan so repeated calls with the same protocol
# signature — every forward pass of a PrivateLinear, every step of a
# batched pipeline — reuse the mixing/decode constants.  The key tuple
# is exactly a resolved ``PlanConfig`` plus (shapes, p, seed); an
# auto-planner re-proposing a config between replays lands on the same
# entry, and a config differing ONLY in ``n_spare`` takes the
# ``_replan_n_spare`` fast path (no new Gauss-Jordan inversions).
_PLAN_CACHE: dict = {}
_PLAN_CACHE_STATS = {"hits": 0, "misses": 0, "replans": 0}
# Sibling index for the re-plan fast path: same (scheme, shapes, field,
# seed), any n_spare -> the latest plan, whose sender-side constants a
# different spare count can reuse verbatim.
_PLAN_BY_SIG: dict = {}
# Per-plan subset-matrix caches (phase2_matrix_cached /
# decode_matrix_cached) share process-wide hit counters and a per-plan
# size bound; a runtime facing a pool of n_total workers sees at most
# C(n_total, threshold) distinct subsets but in practice a handful.
_SUBSET_CACHE_STATS = {"hits": 0, "misses": 0}
_SUBSET_CACHE_MAX = 512
# The per-plan decode_check_matrix memo (the master's consistency-check
# Vandermonde), counted process-wide like the other two cache spellings
# so obs.metrics can report all three behind one snapshot().
_DECODE_CHECK_STATS = {"hits": 0, "misses": 0}
# Plans pin O(n_total^2) host matrices (plus device constants once the
# batched engine touches them), and callers key on runtime batch sizes,
# so bound the cache: oldest-inserted entries are evicted first.
_PLAN_CACHE_MAX = 256


def _plan_sig(scheme: Scheme, shapes: BlockShapes, field: Field, seed: int):
    """Everything a plan depends on except the spare count."""
    return (
        scheme.method,
        scheme.s,
        scheme.t,
        scheme.z,
        scheme.lam,
        (shapes.k, shapes.ma, shapes.mb, shapes.s, shapes.t),
        field.p,
        seed,
    )


def _plan_key(scheme: Scheme, shapes: BlockShapes, field: Field, n_spare: int, seed: int):
    return _plan_sig(scheme, shapes, field, seed) + (n_spare,)


def get_plan(
    scheme: Scheme,
    shapes: BlockShapes,
    field: Optional[Field] = None,
    n_spare: int = 0,
    seed: int = 0,
) -> CMPCPlan:
    """Memoized ``make_plan``: one plan per (scheme, shapes, field,
    n_spare, seed) signature, shared across layers and batches.

    A miss whose signature matches a cached plan except for ``n_spare``
    re-plans from that sibling instead of building from scratch:
    evaluation points are prefix-consistent per seed, so the Phase-2
    sender interpolation and the decode inverse carry over unchanged
    and only receiver-side Vandermonde rows are grown or sliced.  An
    auto-planner resizing spares between replays (elastic pools) pays
    no Gauss-Jordan inversions for the switch.
    """
    field = field or Field()
    sig = _plan_sig(scheme, shapes, field, seed)
    key = sig + (n_spare,)
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        sibling = _PLAN_BY_SIG.get(sig)
        if sibling is not None and sibling.n_spare != n_spare:
            outcome = "replan"
            _PLAN_CACHE_STATS["replans"] += 1
            plan = _replan_n_spare(sibling, n_spare, seed)
        else:
            outcome = "miss"
            _PLAN_CACHE_STATS["misses"] += 1
            plan = make_plan(scheme, shapes, field=field, n_spare=n_spare, seed=seed)
        _PLAN_CACHE[key] = plan
        _PLAN_BY_SIG[sig] = plan
        while len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
            _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
    else:
        outcome = "hit"
        _PLAN_CACHE_STATS["hits"] += 1
    if TRACER.enabled:
        TRACER.event(
            "planner.get_plan",
            outcome=outcome,
            method=scheme.method,
            n_workers=scheme.n_workers,
            n_spare=n_spare,
        )
    return plan


def get_plan_for(
    config: PlanConfig,
    shapes: BlockShapes,
    field: Optional[Field] = None,
    seed: int = 0,
) -> CMPCPlan:
    """The ``PlanConfig`` entry point: resolve the construction through
    the registry and fetch the (cached) plan.  Configs that resolve to
    the same scheme — e.g. ``lam=None`` and its pinned ``lambda*`` —
    share one cache entry."""
    if shapes.s != config.s or shapes.t != config.t:
        raise ValueError("config and shapes disagree on (s, t)")
    return get_plan(
        config.scheme(), shapes, field=field, n_spare=config.n_spare, seed=seed
    )


def plan_cache_info() -> dict:
    """{'hits', 'misses', 'replans', 'size'} for the process-wide cache.
    ``replans`` counts misses served by the n_spare fast path (no new
    matrix inversions)."""
    return dict(_PLAN_CACHE_STATS, size=len(_PLAN_CACHE))


def plan_cache_clear() -> None:
    _PLAN_CACHE.clear()
    _PLAN_BY_SIG.clear()
    _ALPHA_CACHE.clear()
    _PLAN_CACHE_STATS.update(hits=0, misses=0, replans=0)


def subset_cache_info() -> dict:
    """Process-wide {'hits', 'misses'} of the per-plan subset caches."""
    return dict(_SUBSET_CACHE_STATS)


def subset_cache_clear() -> None:
    _SUBSET_CACHE_STATS.update(hits=0, misses=0)


def decode_check_cache_info() -> dict:
    """Process-wide {'hits', 'misses'} of the per-plan
    ``decode_check_matrix`` memo."""
    return dict(_DECODE_CHECK_STATS)


def decode_check_cache_clear() -> None:
    _DECODE_CHECK_STATS.update(hits=0, misses=0)


# Evaluation points are prefixes of ONE seeded permutation of the
# nonzero field elements, so plans differing only in pool size share
# alpha prefixes — the invariant behind the n_spare re-plan fast path.
# One permutation costs ~p int64s; bound the cache.
_ALPHA_CACHE: dict = {}
_ALPHA_CACHE_MAX = 16


def _alpha_prefix(field: Field, seed: int, n: int) -> np.ndarray:
    if n >= field.p:
        raise ValueError("field too small for worker count")
    key = (field.p, seed)
    perm = _ALPHA_CACHE.get(key)
    if perm is None:
        rng = np.random.default_rng(seed)
        perm = rng.permutation(field.p - 1).astype(np.int64) + 1
        _ALPHA_CACHE[key] = perm
        while len(_ALPHA_CACHE) > _ALPHA_CACHE_MAX:
            _ALPHA_CACHE.pop(next(iter(_ALPHA_CACHE)))
    return perm[:n].copy()


def make_plan(
    scheme: Scheme,
    shapes: BlockShapes,
    field: Optional[Field] = None,
    n_spare: int = 0,
    seed: int = 0,
) -> CMPCPlan:
    field = field or Field()
    if shapes.s != scheme.s or shapes.t != scheme.t:
        raise ValueError("scheme and shapes disagree on (s, t)")
    n = scheme.n_workers + n_spare
    # distinct nonzero evaluation points (seeded-permutation prefix)
    alphas = _alpha_prefix(field, seed, n)
    va = field.vandermonde(alphas, scheme.fa_powers)
    vb = field.vandermonde(alphas, scheme.fb_powers)
    r = _phase2_rows(scheme, field, alphas, np.arange(scheme.n_workers))
    mix = _mix_from_rows(scheme, field, r, alphas)
    tt = scheme.t * scheme.t
    vnoise = field.vandermonde(alphas, range(tt, tt + scheme.z))
    dec_ids = np.arange(scheme.decode_threshold)
    v_dec = field.vandermonde(alphas[dec_ids], range(scheme.decode_threshold))
    decode_w = field.inv_matrix(v_dec)
    imp = scheme.coded.important_map()
    pos = {u: j for j, u in enumerate(scheme.h_powers)}
    important_idx = np.zeros((scheme.t, scheme.t), np.int64)
    for (i, l), u in imp.items():
        important_idx[i, l] = pos[u]
    plan = CMPCPlan(
        scheme=scheme,
        field=field,
        shapes=shapes,
        n_spare=n_spare,
        alphas=alphas,
        va=va,
        vb=vb,
        mix=mix,
        vnoise=vnoise,
        decode_w=decode_w,
        important_idx=important_idx,
    )
    # stash the sender-side interpolation rows for the re-plan fast path
    object.__setattr__(plan, "_phase2_r", r)
    return plan


def _replan_n_spare(base: CMPCPlan, n_spare: int, seed: int) -> CMPCPlan:
    """Re-plan ``base`` for a different spare count without re-running
    any Gauss-Jordan inversion.

    Evaluation points are prefix-consistent per seed, so the primary
    workers (and hence the Phase-2 sender interpolation rows and the
    decode inverse) are untouched; only receiver-indexed rows of the
    Vandermonde constants grow or shrink.  Shrinking slices; growing
    evaluates Vandermonde rows for the new alphas and extends the mix
    with receiver columns folded from the stashed sender rows.
    """
    scheme, field = base.scheme, base.field
    n_new = scheme.n_workers + n_spare
    n_old = base.n_total
    r = base.__dict__.get("_phase2_r")
    if r is None:  # plan predates the stash (or crossed a process)
        r = _phase2_rows(scheme, field, base.alphas, np.arange(scheme.n_workers))
    if n_new <= n_old:
        alphas = base.alphas[:n_new].copy()
        va = base.va[:n_new].copy()
        vb = base.vb[:n_new].copy()
        vnoise = base.vnoise[:n_new].copy()
        mix = base.mix[:, :n_new].copy()
    else:
        alphas = _alpha_prefix(field, seed, n_new)
        if not np.array_equal(alphas[:n_old], base.alphas):
            raise ValueError(
                "re-plan sibling has mismatched evaluation points "
                "(plan not built from this seed's alpha permutation)"
            )
        new = alphas[n_old:]
        va = np.vstack([base.va, field.vandermonde(new, scheme.fa_powers)])
        vb = np.vstack([base.vb, field.vandermonde(new, scheme.fb_powers)])
        tt = scheme.t * scheme.t
        vnoise = np.vstack(
            [base.vnoise, field.vandermonde(new, range(tt, tt + scheme.z))]
        )
        mix = np.hstack([base.mix, _mix_from_rows(scheme, field, r, new)])
    plan = CMPCPlan(
        scheme=scheme,
        field=field,
        shapes=base.shapes,
        n_spare=n_spare,
        alphas=alphas,
        va=va,
        vb=vb,
        mix=mix,
        vnoise=vnoise,
        decode_w=base.decode_w,  # depends on the (unchanged) first thr alphas
        important_idx=base.important_idx,
    )
    object.__setattr__(plan, "_phase2_r", r)
    return plan
