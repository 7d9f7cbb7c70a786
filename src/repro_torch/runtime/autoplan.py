"""Adaptive construction auto-planner: scheme selection as a feedback loop.

The static benchmark question "which construction is fastest on this
pool?" becomes a control problem once the pool itself drifts — links
degrade mid-stream, workers join and leave between replays.  This
module closes the loop:

1. every replay's :class:`~repro_torch.runtime.metrics.RunMetrics` is
   projected onto the master-observable :class:`ObservedRun` record,
2. a sliding window of records is fitted into a
   :class:`~repro_torch.runtime.metrics.PoolEstimate` (shifted-exponential
   straggler tails per protocol leg, dropout/crash/corruption rates),
3. candidate :class:`~repro_torch.core.constructions.PlanConfig`\\ s are
   scored by the estimate's order-statistic completion model — the
   closed-form prior — blended with the candidate's own observed
   completion percentiles,
4. the winner is re-fitted to the current pool (``fit_to_pool`` spare
   re-accounting) and executed; the plan cache's replan fast path makes
   a spares-only refit nearly free.

Scoring starts from :data:`~repro_torch.runtime.metrics.DEFAULT_ESTIMATE`
(unit-scale exponentials), under which candidates rank purely by how
deep into the pool's order-statistic tail they reach — small Phase-2
sets and small decode thresholds win.  Observations then reshape both
the fitted tails (re-ranking every candidate, even never-run ones) and
the per-candidate blend.  An exploration pass gives each candidate
whose prior is within ``explore_ratio`` of the best a single trial
before the planner settles, so the blend has real data to work with;
clearly dominated candidates are never executed.

``run_adaptive_over_pool`` drives the loop replay-by-replay over a
trace sequence or an :class:`~repro_torch.runtime.pool.ElasticPool`;
``run_pipeline_over_pool(..., planner=...)`` makes the same decisions
at replay boundaries *inside* the pipeline, switching constructions
mid-stream.

A copy of the JAX package's ``repro.runtime.autoplan`` (plain Python and
numpy), kept here so that the port imports nothing of that package;
``run_adaptive_over_pool`` also takes the ``device`` its replays run on.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from ..core.closed_form import predict
from ..core.constructions import PlanConfig
from ..core.planner import BlockShapes, CMPCPlan, get_plan_for
from ..core.protocol import resolve_device
from ..obs.metrics import REGISTRY
from ..obs.tracer import TRACER
from .metrics import (
    DEFAULT_ESTIMATE,
    ObservedRun,
    PoolEstimate,
    RunMetrics,
    estimate_pool,
    observed_run,
    order_stat_mean,
)
from .pipeline import _as_stack
from .pool import ElasticPool, WorkerTrace
from .scheduler import BatchEdgeRun, run_batch_over_pool


@dataclasses.dataclass(frozen=True)
class PlanDecision:
    """One replay's planning outcome."""

    replay: int
    config: PlanConfig  # resolved and pool-fitted (n_spare accounted)
    pool_size: int
    predicted: float  # blended completion score of the winner
    reason: str  # "prior" | "explore" | "observed" | "forced"
    switched: bool  # construction differs from the previous replay
    respared: bool  # only the spare count changed
    # Trace id of this decision's ``autoplan.decide`` event (0 when the
    # tracer was disabled).  The runtimes echo it as ``decision_id`` on
    # the replay span this decision produced, so a trace links every
    # replay back to the reasoning that picked its construction.
    obs_id: int = 0


def _replay_seed(seed: int, k: int) -> int:
    """Deterministic, decorrelated per-replay integer seed."""
    return int(np.random.default_rng([seed, k]).integers(2**31 - 1))


class AutoPlanner:
    """Feedback-driven construction selection across replays.

    ``candidates`` are the PlanConfigs the planner may choose between
    (their ``n_spare`` is ignored — spares are re-fitted to each
    pool).  ``window`` bounds the estimator's memory so a degrading
    pool re-ranks candidates instead of averaging the past away;
    ``explore_ratio`` bounds how bad a prior score may be (relative to
    the best) and still earn an exploratory trial.

    ``cost_m``: when set (the problem's matrix dimension), each
    candidate's compute leg is weighted by its Corollary-10 per-worker
    work relative to the first candidate
    (:func:`~repro_torch.core.closed_form.predict` /
    ``CostPrediction.compute_factor``) — the closed-form cost model
    folded into the prior.  Use it with runtimes that scale
    ``compute_delay`` the same way (``compute_scale``), where a trace's
    delay is time per unit work; observed set times are normalized by
    the same factor before entering the order-stat fit, so runs of
    *different* constructions still train one pool estimate.

    ``decode_mode``: the runtime's corruption-handling strategy the
    planner prices and tunes.  ``"detect"`` prices the decode wait one
    confirming witness deeper once corruption is observed; ``"correct"``
    prices the Berlekamp-Welch wait ``thr + 2e`` with the error budget
    ``e`` fitted from the observed corruption rate
    (:meth:`error_budget`); ``"auto"`` prices whichever is cheaper per
    candidate.
    """

    def __init__(
        self,
        candidates: Sequence[PlanConfig],
        window: int = 12,
        explore_ratio: float = 2.0,
        cost_m: Optional[int] = None,
        decode_mode: str = "detect",
    ):
        if not candidates:
            raise ValueError("need at least one candidate PlanConfig")
        if decode_mode not in ("detect", "correct", "auto"):
            raise ValueError(
                f"decode_mode must be 'detect', 'correct', or 'auto', "
                f"got {decode_mode!r}"
            )
        self.decode_mode = decode_mode
        seen: Dict[str, PlanConfig] = {}
        for c in candidates:
            seen.setdefault(c.resolved().label(), c.resolved())
        self.candidates = tuple(seen.values())
        self.window = int(window)
        self.explore_ratio = float(explore_ratio)
        self.cost_m = cost_m
        self._wf: Dict[str, float] = {}
        if cost_m is not None:
            ref = predict(self.candidates[0], cost_m)
            self._wf = {
                c.label(): predict(c, cost_m).compute_factor(ref)
                for c in self.candidates
            }
        self._runs: deque = deque(maxlen=self.window)
        # Observed completions are conditioned on the pool size they ran
        # on — a median from a 40-worker pool says nothing about the
        # same construction on 16 workers — so the per-candidate windows
        # are keyed by (label, pool size).  A pool resize therefore
        # hands ranking back to the fitted model (plus one exploration
        # pass at the new size) instead of trusting stale medians.
        self._obs: Dict[tuple, deque] = {}
        self.decisions: List[PlanDecision] = []

    # -- state ---------------------------------------------------------
    @property
    def n_switches(self) -> int:
        """Construction switches (method/s/t/z/lam) across decisions."""
        return sum(d.switched for d in self.decisions)

    @property
    def n_respares(self) -> int:
        """Spares-only refits (same construction, resized pool)."""
        return sum(d.respared for d in self.decisions)

    def estimate(self) -> PoolEstimate:
        """Current fitted pool estimate (windowed observations)."""
        return estimate_pool(self._runs)

    def work_factor(self, config: PlanConfig) -> float:
        """Per-worker compute weight of a candidate (1.0 unless the
        planner was built with ``cost_m``)."""
        return self._wf.get(config.resolved().label(), 1.0)

    def _obs_for(self, config: PlanConfig, pool_size: int) -> deque:
        key = (config.resolved().label(), int(pool_size))
        return self._obs.setdefault(key, deque(maxlen=self.window))

    # -- corruption tuning ---------------------------------------------
    def verify_extras_for(self, est: Optional[PoolEstimate] = None) -> int:
        """Confirming witnesses the planner would demand in ``"detect"``
        mode: one as soon as any corruption has been observed."""
        est = est or self.estimate()
        return 1 if est.corrupt_rate > 0 else 0

    def error_budget(
        self, config: PlanConfig, pool_size: int,
        est: Optional[PoolEstimate] = None,
    ) -> int:
        """Error budget ``e`` the planner would provision for a
        ``"correct"``-mode replay of ``config`` on ``pool_size``:
        the expected corrupt responder count under the fitted
        corruption rate, capped at what the pool can afford
        (``(pool_size - thr) // 2``)."""
        est = est or self.estimate()
        if est.corrupt_rate <= 0:
            return 0
        n_live = int(np.floor(pool_size * (1.0 - est.dropout_rate)))
        n_recv = int(np.floor(n_live * (1.0 - est.crash_rate)))
        cap = (pool_size - config.decode_threshold) // 2
        want = int(np.ceil(est.corrupt_rate * n_recv))
        return max(0, min(want, cap))

    # -- scoring -------------------------------------------------------
    def _threshold(
        self, config: PlanConfig, est: PoolEstimate, pool_size: int
    ) -> int:
        # Price of the decode wait under the planner's decode mode.
        # "detect": corruption observed -> the master withholds
        # acceptance for a confirming witness, one responder deeper
        # into the tail.  "correct": the BW decode waits for
        # thr + 2e responders at the fitted budget.  "auto": whichever
        # wait is shallower (the runtime resolves the same way).
        thr = config.decode_threshold
        detect = thr + self.verify_extras_for(est)
        if self.decode_mode == "detect":
            return detect
        correct = thr + 2 * self.error_budget(config, pool_size, est)
        if self.decode_mode == "correct":
            return correct
        return min(detect, correct)

    def _model(
        self, config: PlanConfig, pool_size: int, est: PoolEstimate
    ) -> float:
        """Order-stat completion model, compute leg weighted by the
        candidate's closed-form work factor (the fitted ready leg is in
        reference work units — see ``observe``)."""
        n_live = int(np.floor(pool_size * (1.0 - est.dropout_rate)))
        if config.n_workers > n_live:
            return float("inf")
        t_set = self.work_factor(config) * order_stat_mean(
            config.n_workers, n_live, est.ready_shift, est.ready_scale
        )
        n_recv = int(np.floor(n_live * (1.0 - est.crash_rate)))
        thr = self._threshold(config, est, pool_size)
        if thr > n_recv:
            return float("inf")
        return t_set + order_stat_mean(
            thr, n_recv, est.resp_shift, est.resp_scale
        )

    def score(
        self, config: PlanConfig, pool_size: int, est: Optional[PoolEstimate] = None
    ) -> float:
        """Blended expected completion of ``config`` on ``pool_size``.

        The closed-form prior is the order-statistic model under the
        fitted estimate; each windowed observation of this exact
        construction *on this pool size* pulls the score toward the
        observed median with weight n/(n+1).  Infeasible configs score
        ``inf``.
        """
        est = est or self.estimate()
        model = self._model(config, pool_size, est)
        if not np.isfinite(model):
            return float("inf")
        obs = self._obs_for(config, pool_size)
        if not obs:
            return model
        p50 = float(np.percentile(list(obs), 50))
        return (model + len(obs) * p50) / (1 + len(obs))

    # -- the loop ------------------------------------------------------
    def decide(self, pool_size: int) -> PlanDecision:
        """Pick the construction for the next replay on ``pool_size``."""
        est = self.estimate()
        prior = {
            c.label(): self._model(c, pool_size, est) for c in self.candidates
        }
        feasible = [c for c in self.candidates if np.isfinite(prior[c.label()])]
        if not feasible:
            raise ValueError(
                f"no candidate construction fits a pool of {pool_size} "
                f"workers (candidates need "
                f"{[c.n_workers for c in self.candidates]})"
            )
        best_prior = min(prior[c.label()] for c in feasible)
        unexplored = [
            c
            for c in feasible
            if not self._obs_for(c, pool_size)
            and prior[c.label()] <= self.explore_ratio * best_prior
        ]
        if unexplored:
            pick = min(unexplored, key=lambda c: prior[c.label()])
            reason = "explore"
        else:
            pick = min(feasible, key=lambda c: self.score(c, pool_size, est))
            reason = "observed" if self._obs_for(pick, pool_size) else "prior"

        prev = self.decisions[-1] if self.decisions else None
        switched = False
        respared = False
        if prev is not None:
            prev_base = prev.config.replace(n_spare=0)
            if prev_base.label() != pick.label():
                switched = True
                if not np.isfinite(self._model(prev_base, pool_size, est)):
                    reason = "forced"  # the old construction no longer fits
            elif prev.pool_size != pool_size:
                respared = True
        decision = PlanDecision(
            replay=len(self.decisions),
            config=pick.fit_to_pool(pool_size),
            pool_size=pool_size,
            predicted=self.score(pick, pool_size, est),
            reason=reason,
            switched=switched,
            respared=respared,
        )
        REGISTRY.counter("autoplan.decisions").inc()
        REGISTRY.counter(f"autoplan.reason.{reason}").inc()
        if TRACER.enabled:
            eid = TRACER.event(
                "autoplan.decide",
                replay=decision.replay,
                config=decision.config.label(),
                n_spare=decision.config.n_spare,
                pool=pool_size,
                predicted=float(decision.predicted),
                reason=reason,
                switched=switched,
                respared=respared,
            )
            decision = dataclasses.replace(decision, obs_id=eid)
        self.decisions.append(decision)
        return decision

    def observe(
        self, config: PlanConfig, metrics: RunMetrics, start: float = 0.0
    ) -> ObservedRun:
        """Feed one replay's outcome back into the estimator.

        The set time enters the shared order-stat fit normalized by the
        construction's work factor, so runs of heavy- and light-work
        candidates train one estimate in reference work units.
        """
        rec = observed_run(metrics, start)
        wf = self.work_factor(config)
        if wf != 1.0 and wf > 0:
            rec = dataclasses.replace(rec, set_time=rec.set_time / wf)
        self._runs.append(rec)
        if any(config.resolved().label() == c.label() for c in self.candidates):
            self._obs_for(config, rec.n_pool).append(rec.completion)
        return rec

    def summary(self) -> dict:
        """JSON-friendly account of every decision (benchmark output)."""
        est = self.estimate()
        return {
            "candidates": [c.label() for c in self.candidates],
            "replays": [
                {
                    "replay": d.replay,
                    "config": d.config.label(),
                    "n_spare": d.config.n_spare,
                    "pool": d.pool_size,
                    "predicted": d.predicted,
                    "reason": d.reason,
                    "switched": d.switched,
                }
                for d in self.decisions
            ],
            "switches": self.n_switches,
            "respares": self.n_respares,
            "decode_mode": self.decode_mode,
            "estimate": {
                "ready_shift": est.ready_shift,
                "ready_scale": est.ready_scale,
                "resp_shift": est.resp_shift,
                "resp_scale": est.resp_scale,
                "dropout_rate": est.dropout_rate,
                "crash_rate": est.crash_rate,
                "corrupt_rate": est.corrupt_rate,
                "n_runs": est.n_runs,
            },
        }


def plan_for_decision(
    decision: PlanDecision,
    k: int,
    ma: int,
    mb: int,
    field=None,
    seed: int = 0,
) -> CMPCPlan:
    """Materialize a decision into a (cached) plan for global operand
    dims ``Y[ma, mb] = A[k, ma]^T B[k, mb]`` — the block shapes follow
    the chosen construction's (s, t)."""
    cfg = decision.config
    shapes = BlockShapes(k=k, ma=ma, mb=mb, s=cfg.s, t=cfg.t)
    return get_plan_for(cfg, shapes, field=field, seed=seed)


@dataclasses.dataclass
class AdaptiveRun:
    """Result of an auto-planned replay sequence."""

    y: np.ndarray  # [K, batch, ma, mb]
    replay_metrics: List[RunMetrics]
    decisions: List[PlanDecision]
    planner: AutoPlanner


def run_adaptive_over_pool(
    planner: AutoPlanner,
    a: np.ndarray,
    b: np.ndarray,
    traces: Union[Sequence[WorkerTrace], ElasticPool],
    seed: int = 0,
    verify_extras="auto",
    master_decode_cost: float = 0.0,
    field=None,
    plan_seed: int = 0,
    compute_scale="auto",
    decode_mode: str = "detect",
    device=None,
) -> AdaptiveRun:
    """Replay-by-replay feedback loop over a (possibly elastic) pool.

    a: [K, batch, k, ma], b: [K, batch, k, mb] ([K, k, m] promotes to
    batch 1) — *global* operand dims, so every candidate construction
    computes the same products regardless of its block split.
    ``traces`` is one :class:`WorkerTrace` per replay or an
    :class:`ElasticPool`; pool sizes may differ between replays, which
    is exactly what the planner's ``fit_to_pool`` spare re-accounting
    (and the plan cache's replan fast path) absorb.  Each replay runs
    the batched engine (:func:`run_batch_over_pool`) under the
    construction the planner picked from everything observed so far.

    ``compute_scale``: ``"auto"`` scales each replay's worker compute
    by the chosen construction's work factor (1.0 for planners without
    ``cost_m``); a float forces one scale for every replay.

    ``decode_mode``: the corruption-handling strategy, *tuned per
    replay* by the planner: the error budget for ``"correct"``/
    ``"auto"`` comes from :meth:`AutoPlanner.error_budget` (the fitted
    corruption rate), and once corruption has been observed the planner
    forces at least one confirming witness in ``"detect"`` mode even
    when ``verify_extras="auto"`` would resolve lower.  Until the
    planner has observations, both fall back to the trace's configured
    fault model.

    Every replay runs on ``device`` (default: the GPU).
    """
    device = resolve_device(device)
    traces = list(traces)
    if not traces:
        raise ValueError("need at least one trace/replay")
    a = _as_stack(a)
    b = _as_stack(b)
    if a.ndim == 3:
        a = a[:, None]
    if b.ndim == 3:
        b = b[:, None]
    if a.ndim != 4 or b.ndim != 4:
        raise ValueError(
            f"expected [K, batch, k, m] operand stacks, got {a.shape} {b.shape}"
        )
    if a.shape[0] != len(traces) or b.shape[0] != len(traces):
        raise ValueError(
            f"{len(traces)} traces but operand stacks of depth "
            f"{a.shape[0]} / {b.shape[0]}"
        )
    gk, ma = int(a.shape[2]), int(a.shape[3])
    mb = int(b.shape[3])

    ys = []
    replay_metrics: List[RunMetrics] = []
    for idx, trace in enumerate(traces):
        decision = planner.decide(trace.n)
        plan = plan_for_decision(
            decision, gk, ma, mb, field=field, seed=plan_seed
        )
        scale = (
            planner.work_factor(decision.config)
            if compute_scale == "auto"
            else float(compute_scale)
        )
        # Planner-tuned corruption handling: once the estimator has
        # seen corruption, its fitted rate sets the error budget
        # (correct) and forces a confirming witness (detect); with no
        # observations yet, "auto" falls back to the trace's configured
        # fault model inside the runtime.
        e_k = planner.error_budget(decision.config, trace.n)
        extras_k = verify_extras
        if verify_extras == "auto" and planner.verify_extras_for() > 0:
            extras_k = planner.verify_extras_for()
        run: BatchEdgeRun = run_batch_over_pool(
            plan,
            a[idx],
            b[idx],
            trace,
            seed=_replay_seed(seed, idx),
            verify_extras=extras_k,
            master_decode_cost=master_decode_cost,
            compute_scale=scale,
            decode_mode=decode_mode,
            error_budget=e_k if e_k > 0 else "auto",
            # Links this replay's trace records to the decision that
            # picked its construction (decision_id -> autoplan.decide).
            obs_attrs={
                "replay": idx,
                "decision_id": decision.obs_id,
                "config": decision.config.label(),
            },
            device=device,
        )
        planner.observe(decision.config, run.metrics)
        ys.append(run.y)
        replay_metrics.append(run.metrics)
    return AdaptiveRun(
        y=np.stack(ys),
        replay_metrics=replay_metrics,
        decisions=list(planner.decisions[-len(traces):]),
        planner=planner,
    )
