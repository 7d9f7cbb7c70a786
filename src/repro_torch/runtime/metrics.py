"""Per-run runtime metrics and cross-run aggregation.

``RunMetrics`` records the timeline of one event-driven execution
(when each protocol phase unblocked), the communication trace (with the
bytes-level view from ``protocol.Trace``), which workers actually
served each phase, and what the master rejected as corrupt.  These are
the quantities behind the paper's edge claims: completion time under
stragglers, and how many provisioned workers were actually needed.

``summarize`` aggregates a list of runs into the latency distribution
(mean / p50 / p95 / max), mean effective worker count, decode-subset
statistics (how many distinct responder subsets the master decoded
from — the hit pattern of the planner's subset-matrix caches), and
total wire bytes.

A copy of the JAX package's ``repro.runtime.metrics`` (plain Python and numpy),
kept here so that the port imports nothing of that package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core.protocol import Trace


@dataclasses.dataclass
class RunMetrics:
    """Timeline + accounting of one run over a worker pool."""

    completion_time: float  # master accepts the decode
    phase1_last_share: float  # last share delivered to a live worker
    phase2_set_time: float  # fastest n_workers finished H -> set fixed
    first_response: float  # first I(alpha_n) at the master
    n_provisioned: int
    n_dropped: int
    n_crashed: int
    phase2_ids: np.ndarray  # the fastest-subset Phase-2 senders
    responder_ids: np.ndarray  # accepted Phase-3 decode subset
    confirmed_by: np.ndarray  # extra responders that verified the decode
    rejected_ids: np.ndarray  # responders detected as corrupt
    trace: Trace  # communication (elements + bytes views)
    batch: int = 1  # products served by this replay (batched runtime)
    # Berlekamp-Welch-identified corrupt responders whose errors the
    # decode corrected (decode_mode="correct"); empty under "detect".
    corrected_workers: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([], np.int64)
    )

    @property
    def effective_workers(self) -> int:
        """Distinct workers whose output the result depends on."""
        return int(
            np.union1d(np.union1d(self.phase2_ids, self.responder_ids),
                       self.confirmed_by).size
        )

    @property
    def observed_corrupt(self) -> int:
        """Responders caught misbehaving, either strategy: detected and
        discarded (``rejected_ids``) or BW-corrected
        (``corrected_workers``)."""
        return int(self.rejected_ids.size + self.corrected_workers.size)

    @property
    def decode_subset_key(self) -> Tuple[int, ...]:
        return tuple(int(i) for i in np.sort(self.responder_ids))


@dataclasses.dataclass
class PipelineMetrics:
    """Aggregate view of K pipelined batched replays.

    Per-replay timestamps are *absolute* on the shared pipeline clock
    (replay k's Phase-1 upload starts once the master's per-worker
    links free up from replay k-1).  ``occupancy`` is the mean number
    of in-flight replays over the makespan — sum of per-replay spans
    divided by the makespan; 1.0 means no overlap at all, values
    toward ``depth`` mean the pipeline is saturated.
    ``phase1_overlap`` totals the Phase-1 upload time that ran while
    an earlier replay was still in flight (the transfer/compute
    overlap the scalar runtime could not express).
    """

    depth: int  # replays in flight (K)
    batch: int  # products per replay
    products: int  # depth * batch
    makespan: float  # last replay accepted (absolute)
    completions: np.ndarray  # [K] absolute acceptance times
    starts: np.ndarray  # [K] first Phase-1 send of each replay
    occupancy: float  # mean in-flight replays = sum(span) / makespan
    phase1_overlap: float  # upload time overlapped with earlier replays
    trace: Trace  # aggregate communication across all replays

    def __post_init__(self):
        # Loud guards: an empty or time-inverted pipeline is a harness
        # bug, not a statistic — fail here instead of emitting NaN /
        # division-by-zero ratios downstream.
        if self.depth < 1:
            raise ValueError(
                f"pipeline needs at least one replay, got depth={self.depth}"
            )
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {self.batch}")
        if not np.isfinite(self.makespan) or self.makespan < 0:
            raise ValueError(
                f"makespan must be finite and >= 0, got {self.makespan}"
            )

    @property
    def spans(self) -> np.ndarray:
        return self.completions - self.starts

    @property
    def overlap_ratio(self) -> float:
        """Phase-1 overlap as a fraction of the makespan.  A zero
        makespan (every leg instantaneous) has no overlap to attribute,
        so the ratio is a defined 0.0 — never a division error."""
        if self.makespan <= 0:
            return 0.0
        return float(self.phase1_overlap / self.makespan)


def summarize(runs: List[RunMetrics]) -> Dict:
    """Aggregate a list of runs into distribution-level statistics.

    An empty list is a defined outcome, not an error: callers summarize
    whatever subset of runs survived (e.g. all-failure fault sweeps),
    so ``summarize([])`` returns ``{"runs": 0}`` — no percentile or
    mean is ever taken over zero samples (regression-tested).
    """
    if not runs:
        return {"runs": 0}
    times = np.array([r.completion_time for r in runs])
    subsets: Dict[Tuple[int, ...], int] = {}
    for r in runs:
        k = r.decode_subset_key
        subsets[k] = subsets.get(k, 0) + 1
    top = sorted(subsets.items(), key=lambda kv: -kv[1])[:3]
    return {
        "runs": len(runs),
        "products": int(sum(r.batch for r in runs)),
        "completion_mean": float(times.mean()),
        "completion_p50": float(np.percentile(times, 50)),
        "completion_p95": float(np.percentile(times, 95)),
        "completion_max": float(times.max()),
        "effective_workers_mean": float(
            np.mean([r.effective_workers for r in runs])
        ),
        "n_provisioned": runs[0].n_provisioned,
        "dropped_mean": float(np.mean([r.n_dropped for r in runs])),
        "rejected_total": int(sum(r.rejected_ids.size for r in runs)),
        "corrected_total": int(sum(r.corrected_workers.size for r in runs)),
        "decode_subsets_distinct": len(subsets),
        "decode_subsets_top": [
            {"subset": list(k), "count": c} for k, c in top
        ],
        "wire_bytes_mean": float(np.mean([r.trace.total_bytes for r in runs])),
    }


# ----------------------------------------------------------------------
# estimators: what the master can infer about the pool from its runs
# ----------------------------------------------------------------------
#
# The event loop's two waits are order statistics of i.i.d. per-worker
# delays: the Phase-2 set fixes at the n_workers-th fastest
# share+compute completion, and the decode at the (threshold+extras)-th
# fastest exchange+uplink response.  Under the literature's
# shifted-exponential straggler model the k-th of n order statistic has
# mean ``shift + scale * (H_n - H_{n-k})`` (harmonic-number
# differences), so each observed run contributes one linear equation in
# (shift, scale) per wait — a handful of runs over different (k, n)
# pins both legs, and an auto-planner can extrapolate completion times
# to constructions it has never executed.


def harmonic(n: int) -> float:
    """H_n = sum_{i=1..n} 1/i (H_0 = 0)."""
    n = int(n)
    if n <= 0:
        return 0.0
    return float(np.sum(1.0 / np.arange(1, n + 1)))


def order_stat_mean(k: int, n: int, shift: float, scale: float) -> float:
    """Mean k-th of n order statistic of shift + Exp(scale) draws."""
    if k <= 0:
        return 0.0
    if k > n:
        return float("inf")
    return shift + scale * (harmonic(n) - harmonic(n - k))


def fit_order_stats(samples: Sequence[Tuple[float, int, int]]) -> Tuple[float, float]:
    """Least-squares (shift, scale) from (value, k, n) order-stat samples.

    Each sample says "the k-th of n i.i.d. delays was observed at
    ``value``", i.e. ``value ~= shift + scale * (H_n - H_{n-k})``.
    With fewer than two distinct harmonic gaps the system is
    underdetermined; attribute everything to ``scale`` (shift 0), which
    keeps extrapolation proportional — the conservative choice for
    ranking constructions by tail exposure.  ``scale`` is clamped >= 0.
    """
    pts = [
        (float(v), harmonic(n) - harmonic(n - k))
        for v, k, n in samples
        if 0 < k <= n
    ]
    if not pts:
        return 0.0, 0.0
    v = np.array([p[0] for p in pts])
    h = np.array([p[1] for p in pts])
    if np.ptp(h) < 1e-12 or len(pts) < 2:
        mean_h = float(h.mean())
        return 0.0, float(v.mean() / mean_h) if mean_h > 0 else 0.0
    a = np.stack([np.ones_like(h), h], axis=1)
    (shift, scale), *_ = np.linalg.lstsq(a, v, rcond=None)
    if scale < 0:  # pathological fit; fall back to proportional
        mean_h = float(h.mean())
        return 0.0, float(v.mean() / mean_h) if mean_h > 0 else 0.0
    return float(shift), float(scale)


@dataclasses.dataclass(frozen=True)
class ObservedRun:
    """Master-observable outcome of one replay — auto-planner food.

    All times are relative to the replay's own start (pass the absolute
    pipeline start to ``observed_run`` for pipelined replays).
    """

    n_pool: int  # provisioned workers
    n_workers: int  # Phase-2 set size (k of the ready order stat)
    n_ready_pool: int  # live workers racing for the set (its n)
    thr_arrived: int  # responses in hand at acceptance
    n_receivers: int  # live, non-crashed workers able to respond
    set_time: float  # Phase-2 set announcement
    response_delta: float  # completion - set_time (exchange+uplink leg)
    completion: float
    n_dropped: int
    n_rejected: int
    n_corrected: int = 0  # BW-corrected responders (decode_mode="correct")


def observed_run(m: RunMetrics, start: float = 0.0) -> ObservedRun:
    """Project a :class:`RunMetrics` onto what the master could observe."""
    n_live = m.n_provisioned - m.n_dropped
    return ObservedRun(
        n_pool=m.n_provisioned,
        n_workers=int(m.phase2_ids.size),
        n_ready_pool=n_live,
        thr_arrived=int(
            m.responder_ids.size + m.confirmed_by.size + m.rejected_ids.size
            + m.corrected_workers.size
        ),
        n_receivers=n_live - m.n_crashed,
        set_time=float(m.phase2_set_time - start),
        response_delta=float(m.completion_time - m.phase2_set_time),
        completion=float(m.completion_time - start),
        n_dropped=m.n_dropped,
        n_rejected=int(m.rejected_ids.size),
        n_corrected=int(m.corrected_workers.size),
    )


@dataclasses.dataclass(frozen=True)
class PoolEstimate:
    """Fitted pool behaviour: straggler tails and fault rates.

    ``ready_*`` parameterize the share+compute leg (Phase-1 delivery
    through H(alpha_n) completion), ``resp_*`` the exchange+uplink leg
    (Phase-2 announcement through a response landing at the master),
    both as shifted exponentials.  Rates are empirical frequencies.
    """

    ready_shift: float
    ready_scale: float
    resp_shift: float
    resp_scale: float
    dropout_rate: float
    crash_rate: float
    corrupt_rate: float
    n_runs: int

    def predict_completion(
        self, n_workers: int, threshold: int, pool_size: int
    ) -> float:
        """Expected completion of a construction on this pool.

        ``inf`` when the pool cannot field the Phase-2 set or the
        decode threshold after expected dropouts/crashes — the planner
        treats that as infeasible.
        """
        n_live = int(np.floor(pool_size * (1.0 - self.dropout_rate)))
        if n_workers > n_live:
            return float("inf")
        t_set = order_stat_mean(
            n_workers, n_live, self.ready_shift, self.ready_scale
        )
        n_recv = int(np.floor(n_live * (1.0 - self.crash_rate)))
        if threshold > n_recv:
            return float("inf")
        t_resp = order_stat_mean(
            threshold, n_recv, self.resp_shift, self.resp_scale
        )
        return t_set + t_resp


# Uninformed prior: unit-scale exponentials on both legs, no faults.
# Ranking candidates under it orders them purely by harmonic gaps —
# i.e. by how deep into the pool's tail each construction must reach.
DEFAULT_ESTIMATE = PoolEstimate(
    ready_shift=0.0,
    ready_scale=1.0,
    resp_shift=0.0,
    resp_scale=1.0,
    dropout_rate=0.0,
    crash_rate=0.0,
    corrupt_rate=0.0,
    n_runs=0,
)


def estimate_pool(runs: Sequence[ObservedRun]) -> PoolEstimate:
    """Fit a :class:`PoolEstimate` from observed replays.

    Runs may come from *different* constructions and pool sizes — that
    diversity is what makes the order-stat fits well-posed (each run
    contributes a different harmonic gap).  Falls back to
    :data:`DEFAULT_ESTIMATE` on an empty list.
    """
    runs = list(runs)
    if not runs:
        return DEFAULT_ESTIMATE
    ready_shift, ready_scale = fit_order_stats(
        [(r.set_time, r.n_workers, r.n_ready_pool) for r in runs]
    )
    resp_shift, resp_scale = fit_order_stats(
        [(r.response_delta, r.thr_arrived, r.n_receivers) for r in runs]
    )
    pool = sum(r.n_pool for r in runs)
    recv = sum(r.n_receivers for r in runs)
    return PoolEstimate(
        ready_shift=ready_shift,
        ready_scale=ready_scale,
        resp_shift=resp_shift,
        resp_scale=resp_scale,
        dropout_rate=sum(r.n_dropped for r in runs) / max(pool, 1),
        crash_rate=sum(r.n_ready_pool - r.n_receivers for r in runs)
        / max(sum(r.n_ready_pool for r in runs), 1),
        corrupt_rate=sum(r.n_rejected + r.n_corrected for r in runs)
        / max(recv, 1),
        n_runs=len(runs),
    )
